"""Born (linearized) modeling (port of ``physicsbasedfwi2_tpu/ops/born.py``):
single-scattering data from a model perturbation, the JVP of the
nonlinear forward operator.

The JAX package takes ``jax.jvp`` of its propagators.  Here the
propagators run once under ``torch.autograd.forward_ad`` with the model a
dual tensor (the background, the perturbation its tangent) and autograd
off: the time loop is then a plain loop (``chunked_checkpoint_scan``
keeps no checkpoints and replays no CUDA graph without autograd and with
dual parameters), carrying each field and its tangent, twice the fields'
memory and no tape.  Plain PyTorch: no kernel.
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD

from physicsbasedfwi2_tpu_torch.ops.acoustic import (
    AcousticConfig, simulate_acoustic,
)


def born_acoustic(vp, dvp, wavelet, src_z, src_x, rcv_z, rcv_x,
                  cfg: AcousticConfig):
    """Linearized scattered data d(recs)/d(vp) . dvp of
    :func:`simulate_acoustic`.

    Returns (background_recs, scattered_recs), both [ns, nt, nr]."""
    with torch.no_grad(), fwAD.dual_level():
        recs = simulate_acoustic(fwAD.make_dual(vp, dvp.to(vp.dtype)),
                                 wavelet, src_z, src_x, rcv_z, rcv_x, cfg)
        out = fwAD.unpack_dual(recs)
    return out.primal, out.tangent


def born_elastic(vp, vs, rho, dvp, dvs, wavelet, src_z, src_x, rcv_z,
                 rcv_x, cfg):
    """Elastic Born modeling of the split-PML ``simulate_elastic`` with
    respect to (vp, vs) perturbations (rho held).

    Returns ((vx, vz) background, (vx, vz) scattered), each [ns, nt,
    nr]."""
    from physicsbasedfwi2_tpu_torch.ops.elastic import simulate_elastic
    with torch.no_grad(), fwAD.dual_level():
        recs = simulate_elastic(fwAD.make_dual(vp, dvp.to(vp.dtype)),
                                fwAD.make_dual(vs, dvs.to(vs.dtype)), rho,
                                wavelet, src_z, src_x, rcv_z, rcv_x, cfg)
        outs = [fwAD.unpack_dual(r) for r in recs]
    return (tuple(o.primal for o in outs), tuple(o.tangent for o in outs))
