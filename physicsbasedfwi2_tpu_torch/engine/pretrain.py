"""Generative VAE pretraining for frozen-decoder latent inversion (port of
``physicsbasedfwi2_tpu/engine/pretrain.py``).

The two-stage pipeline of BASELINE config 4: a model-domain VAE
(VaeNoPhy, Vaevel) trains on velocity models without physics, then
:class:`LatentInversionEngine` freezes its decoder and inverts the latent
through the propagator::

    bank = make_model_bank(48, 151, 201, water_rows=6, seed=3)
    net, norm, history = pretrain_model_vae(bank, batch_size=8, lr=2e-3,
                                            device="cuda:0")
    engine = create_engine(get_workload("latent_inversion"),
                           decoder_net=net, decoder_norm=norm)
"""

from __future__ import annotations

import numpy as np
import torch

from physicsbasedfwi2_tpu_torch.data.synthetic import make_marmousi_like
from physicsbasedfwi2_tpu_torch.device import default_device
from physicsbasedfwi2_tpu_torch.models.vae import ModelVae, kl_divergence


def make_model_bank(n: int, nz: int, nx: int, *, water_rows: int = 0,
                    seed: int = 0) -> np.ndarray:
    """A prior ensemble of ``n`` velocity models [n, nz, nx] (numpy,
    float32): :func:`make_marmousi_like` of seeds ``seed`` ... ``seed +
    n - 1``."""
    return np.stack([make_marmousi_like(nz, nx, seed=seed + i,
                                        water_rows=water_rows)
                     for i in range(n)])


def pretrain_model_vae(models: np.ndarray, *, latent_dim: int = 8,
                       filters=(8, 16, 32), epochs: int = 200,
                       batch_size: int = 8, lr: float = 1e-3,
                       kl_weight: float = 1e-4, seed: int = 0,
                       vmin: float | None = None, vmax: float | None = None,
                       device=None):
    """Train a :class:`ModelVae` on [N, nz, nx] velocity models scaled to
    [0, 1] by (vmin, vmax) (default: the models' range): Adam at ``lr``
    on the reconstruction MSE plus ``kl_weight`` times the KL term, in
    batches of ``batch_size`` in the order of numpy's
    ``default_rng(seed)`` shuffle each epoch (the JAX package's order).
    The weights start from a generator seeded ``seed``; every training
    decode samples its latent from a generator on ``device`` seeded
    ``seed + 1`` (the JAX package draws from ``jax.random`` keys, so the
    noise differs).  ``device`` defaults to the first CUDA card (raises
    without one).

    Returns (net, norm, history): the trained net on ``device``, norm =
    (vmin, vmax) mapping the decoder's [0, 1] output back to velocities
    (hand both to ``LatentInversionEngine(decoder_net=net,
    decoder_norm=norm)``), and each epoch's mean reconstruction MSE.
    """
    device = torch.device(device if device is not None else default_device())
    models = np.asarray(models, np.float32)
    n, nz, nx = models.shape
    vmin = float(models.min()) if vmin is None else vmin
    vmax = float(models.max()) if vmax is None else vmax
    x01 = (models - vmin) / (vmax - vmin + 1e-12)
    x01 = torch.as_tensor(x01, device=device)[..., None]  # [N, nz, nx, 1]
    net = ModelVae(out_shape=(nz, nx), in_shape=(nz, nx, 1),
                   latent_dim=latent_dim, filters=tuple(filters),
                   generator=torch.Generator().manual_seed(seed)).to(device)
    # optax.adam's defaults
    opt = torch.optim.Adam(net.parameters(), lr=lr)
    noise = torch.Generator(device=device).manual_seed(seed + 1)
    history = []
    idx = np.arange(n)
    nprng = np.random.default_rng(seed)
    for _ in range(epochs):
        nprng.shuffle(idx)
        recs = []
        for s in range(0, n, batch_size):
            batch = x01[torch.as_tensor(idx[s: s + batch_size],
                                        device=device)]
            recon, mu, logvar, _ = net(batch, deterministic=False,
                                       generator=noise)
            rec = torch.mean((recon - batch) ** 2)
            loss = rec + kl_weight * kl_divergence(mu, logvar)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            recs.append(rec.detach())
        # one device sync an epoch; the float64 sum of the float32
        # batch losses, as the JAX loop sums its host floats
        history.append(sum(torch.stack(recs).tolist())
                       / max(1, -(-n // batch_size)))
    return net, (vmin, vmax), history
