"""The port's data layer (``physicsbasedfwi2_tpu_torch/data``) against the
JAX package's, case for case after tests/test_data.py: the npy contracts
and their scales, ``flip`` from the same numpy seed, the tree round
trips, the native npy loader and SU reader against numpy in both byte
orders, the SEG-Y and binary readers, ``resample_grid`` against
``jax.image.resize`` when enlarging and when shrinking, the canonical
grids bit for bit, and SU ingestion."""

import os

import jax
import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu.data import create_dataset as j_create_dataset
from physicsbasedfwi2_tpu.data import marmousi as j_marmousi
from physicsbasedfwi2_tpu.data import prep as j_prep
from physicsbasedfwi2_tpu.data.synthetic import (
    SyntheticAcousticWorkload as JAcoustic,
    SyntheticElasticWorkload as JElastic,
)
from physicsbasedfwi2_tpu.data.synthetic import (
    write_elastic_npy_tree as j_write_elastic,
    write_npy_tree as j_write_npy,
)
from physicsbasedfwi2_tpu_torch.data import (
    NpyDictDataset, create_dataset, marmousi, native_loader, native_su, prep,
    register_dataset,
)
from physicsbasedfwi2_tpu_torch.data import npy_datasets
from physicsbasedfwi2_tpu_torch.data.synthetic import (
    acoustic_workload_from_disk, elastic_workload_from_disk,
    latent_workload_from_disk, write_elastic_npy_tree, write_npy_tree,
)

from torch_parity import n, port_elastic_workload, port_workload

torch.set_num_threads(1)

MODES = ["unalignedVelABCD2", "unalignedVelABCDEl", "unalignedVelLatent2",
         "unaligned2", "unalignedAC2", "unalignedBD2", "unalignedBDE2"]


@pytest.fixture(scope="module")
def npy_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    rng = np.random.default_rng(0)
    for letter, shape in (("A", (4, 100, 20)), ("B", (30, 40)),
                          ("C", (30, 40)), ("D", (4, 100, 20)),
                          ("E", (30, 40))):
        d = os.path.join(root, "train" + letter)
        os.makedirs(d)
        for i in range(3):
            np.save(os.path.join(d, f"{i}.npy"),
                    rng.random(shape).astype(np.float32))
    return root


def test_mode_registry_equals_jax():
    from physicsbasedfwi2_tpu.data import npy_datasets as j_npy
    assert npy_datasets._MODES == j_npy._MODES
    register_dataset("t_extra", letters="AB", scale={"B": 2.0})
    assert npy_datasets._MODES["t_extra"] == {"letters": "AB",
                                             "scale": {"B": 2.0}}
    del npy_datasets._MODES["t_extra"]


@pytest.mark.parametrize("mode", MODES)
def test_npy_dataset_contract_and_scales(npy_tree, mode):
    ds, ref = create_dataset(npy_tree, mode), j_create_dataset(npy_tree, mode)
    assert isinstance(ds, NpyDictDataset) and len(ds) == len(ref) == 3
    for i in range(3):
        a, b = ds[i], ref[i]
        assert a.keys() == b.keys()
        for k in a:
            if k.endswith("_paths"):
                assert a[k] == b[k]
            else:
                assert a[k].dtype == np.float32
                np.testing.assert_array_equal(a[k], b[k])
    raw = np.load(os.path.join(npy_tree, "trainB", "0.npy"))
    scale = {"unalignedVelABCDEl": 100.0}.get(mode, 1.0)
    if "B" in ds.letters:
        np.testing.assert_allclose(ds[0]["B"], raw * scale, rtol=1e-6)
    if mode == "unalignedVelLatent2":
        a = np.load(os.path.join(npy_tree, "trainA", "0.npy"))
        np.testing.assert_allclose(ds[0]["A"], a * 10.0, rtol=1e-6)


@pytest.mark.parametrize("flip,seed", [(False, 0), (True, 0), (True, 3)])
def test_batches_and_flip_match_jax(npy_tree, flip, seed):
    ds = create_dataset(npy_tree, "unalignedVelABCD2", max_size=3)
    ref = j_create_dataset(npy_tree, "unalignedVelABCD2", max_size=3)
    got = list(ds.batches(2, seed=seed, flip=flip))
    want = list(ref.batches(2, seed=seed, flip=flip))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            if k.endswith("_paths"):
                assert a[k] == b[k]
            else:
                np.testing.assert_array_equal(a[k], b[k])
    assert len(list(ds.batches(2, drop_last=True))) == 1


def test_flip_mirrors_the_lateral_axis(npy_tree):
    ds = create_dataset(npy_tree, "unalignedVelABCD2")
    plain = next(ds.batches(3, shuffle=False))
    flipped_any = False
    for seed in range(5):
        b = next(ds.batches(3, shuffle=False, flip=True, seed=seed))
        for i in range(3):
            same = np.array_equal(b["B"][i], plain["B"][i])
            mirrored = np.array_equal(b["B"][i], plain["B"][i][..., ::-1])
            assert same or mirrored
            flipped_any |= mirrored
    assert flipped_any


def _j_acoustic():
    return JAcoustic.build(nz=32, nx=40, nt=120, dt=0.001, num_shots=2,
                           num_receivers=10, water_rows=4, chunk=25,
                           pml_width=10)


def _j_elastic():
    return JElastic.build(nz=36, nx=48, nt=60, dt=0.0015, num_shots=3,
                          num_receivers=12, water_rows=4, chunk=20,
                          pml_width=8)


def test_acoustic_tree_round_trips_both_ways(tmp_path):
    jwl = _j_acoustic()
    j_write_npy(str(tmp_path / "jax"), jwl, write_wavelets=True)
    write_npy_tree(str(tmp_path / "port"), port_workload(jwl),
                   write_wavelets=True)
    for letter in "ABCD":
        a = np.load(tmp_path / "port" / f"train{letter}" / "0.npy")
        b = np.load(tmp_path / "jax" / f"train{letter}" / "0.npy")
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    wl = acoustic_workload_from_disk(
        str(tmp_path / "jax"), nz=32, nx=40, dx=10.0, nt=120, dt=0.001,
        pml_width=10, chunk=25, wavelet_from_data=True, device="cpu")
    assert wl.from_disk and wl.device == torch.device("cpu")
    np.testing.assert_array_equal(n(wl.obs), np.asarray(jwl.obs))
    np.testing.assert_array_equal(n(wl.vp_true), np.asarray(jwl.vp_true))
    np.testing.assert_array_equal(n(wl.vp_start), np.asarray(jwl.vp_start))
    np.testing.assert_array_equal(n(wl.obs_norm), np.asarray(jwl.obs_norm))
    assert tuple(wl.wavelet.shape) == (2, 120)
    np.testing.assert_array_equal(n(wl.wavelet[1]), np.asarray(jwl.wavelet))
    for a, b in zip(wl.geom, (jwl.acq.src_z, jwl.acq.src_x, jwl.acq.rcv_z,
                              jwl.acq.rcv_x)):
        np.testing.assert_array_equal(n(a), np.asarray(b))


def test_elastic_tree_round_trips_both_ways(tmp_path):
    jwl = _j_elastic()
    j_write_elastic(str(tmp_path / "jax"), jwl)
    write_elastic_npy_tree(str(tmp_path / "port"), port_elastic_workload(jwl))
    for letter in "ABCD":
        a = np.load(tmp_path / "port" / f"train{letter}" / "0.npy")
        b = np.load(tmp_path / "jax" / f"train{letter}" / "0.npy")
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    from physicsbasedfwi2_tpu.data.synthetic import (
        elastic_workload_from_disk as j_from_disk)
    kw = dict(nz=36, nx=48, dx=20.0, nt=60, dt=0.0015, pml_width=8,
              chunk=20, water_rows=4, rcv_follow_seabed=True)
    ref = j_from_disk(str(tmp_path / "jax"), **kw)
    wl = elastic_workload_from_disk(str(tmp_path / "jax"), **kw,
                                    device="cpu")
    assert wl.from_disk and wl.acq.num_shots == 3
    for k in ("vp", "vs", "rho"):
        np.testing.assert_array_equal(n(wl.true[k]), np.asarray(ref.true[k]))
        np.testing.assert_array_equal(n(wl.start[k]),
                                      np.asarray(ref.start[k]))
    np.testing.assert_array_equal(n(wl.obs_vx), np.asarray(ref.obs_vx))
    np.testing.assert_array_equal(n(wl.obs_vz), np.asarray(ref.obs_vz))
    for a, b in zip(wl.geom, ref.geom):
        np.testing.assert_array_equal(n(a), np.asarray(b))


def test_elastic_tree_without_trainB_takes_the_start(tmp_path):
    jwl = _j_elastic()
    j_write_elastic(str(tmp_path), jwl)
    import shutil
    shutil.rmtree(tmp_path / "trainB")
    wl = elastic_workload_from_disk(
        str(tmp_path), nz=36, nx=48, dx=20.0, nt=60, dt=0.0015,
        pml_width=8, chunk=20, water_rows=4, device="cpu")
    for k in ("vp", "vs", "rho"):
        assert torch.equal(wl.true[k], wl.start[k])


def test_latent_tree_scales_gathers_by_ten(tmp_path):
    from physicsbasedfwi2_tpu.data.synthetic import (
        latent_workload_from_disk as j_latent)
    rng = np.random.default_rng(5)
    for i in range(2):
        for letter, shape in (("A", (3, 50, 12)), ("B", (20, 24))):
            d = tmp_path / f"train{letter}"
            d.mkdir(exist_ok=True)
            np.save(d / f"{i}.npy",
                    (rng.random(shape) * 1000 + 1500).astype(np.float32))
    kw = dict(nz=20, nx=24, dx=10.0, nt=50, dt=0.0015, pml_width=8,
              chunk=10, sample=1)
    ref = j_latent(str(tmp_path), **kw)
    wl = latent_workload_from_disk(str(tmp_path), **kw, device="cpu")
    raw = np.load(tmp_path / "trainA" / "1.npy")
    np.testing.assert_allclose(n(wl.obs), raw * 10.0, rtol=1e-6)
    np.testing.assert_array_equal(n(wl.obs), np.asarray(ref.obs))
    np.testing.assert_array_equal(n(wl.vp_true), np.asarray(ref.vp_true))
    assert torch.equal(wl.vp_start, wl.vp_true) and wl.from_disk


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("dtype", ["f4", "f8"])
def test_native_npy_loader_matches_numpy(tmp_path, order, dtype):
    rng = np.random.default_rng(1)
    paths = []
    for i, shape in enumerate([(4, 100, 20), (30, 40), (7,)]):
        p = str(tmp_path / f"{i}.npy")
        np.save(p, rng.standard_normal(shape).astype(order + dtype))
        paths.append(p)
    assert native_loader.native_available()
    loader = native_loader.PrefetchNpyLoader(paths, n_threads=2, capacity=2)
    assert loader._h is not None  # the native path, not the fallback
    got = list(loader)
    loader.close()
    assert len(got) == 3
    for a, p in zip(got, paths):
        ref = np.load(p).astype(np.float32)
        assert a.dtype == np.float32 and a.shape == ref.shape
        np.testing.assert_array_equal(a, ref)


def test_native_libraries_build_under_build_dir():
    from physicsbasedfwi2_tpu_torch.data import _native_build
    assert native_loader.native_available() and native_su.native_available()
    built = sorted(p.name for p in _native_build.build_dir().glob("lib*.so"))
    assert any(p.startswith("libnpy_loader_") for p in built)
    assert any(p.startswith("libsu_reader_") for p in built)
    assert _native_build.load_native_lib("no_such_source.cpp") is None


def _write_su(path, order, data, dt_us):
    ns = data.shape[1]
    u16 = np.dtype(np.uint16).newbyteorder(order)
    f32 = np.dtype(np.float32).newbyteorder(order)
    with open(path, "wb") as f:
        for tr in data:
            hdr = np.zeros(240, np.uint8)
            hdr[114:116] = np.frombuffer(np.array([ns], u16).tobytes(),
                                         np.uint8)
            hdr[116:118] = np.frombuffer(np.array([dt_us], u16).tobytes(),
                                         np.uint8)
            f.write(hdr.tobytes())
            f.write(tr.astype(f32).tobytes())


@pytest.mark.parametrize("order", ["<", ">"])
def test_su_native_reader_matches_numpy_and_jax(tmp_path, order, monkeypatch):
    d = np.random.default_rng(3).standard_normal((5, 33)).astype(np.float32)
    p = str(tmp_path / "t.su")
    _write_su(p, order, d, 750)
    before = native_su.native_reads
    nat, dt_n = prep.read_su_gather(p)
    assert native_su.native_reads == before + 1
    np.testing.assert_array_equal(nat, d)
    assert abs(dt_n - 750e-6) < 1e-12
    ref, dt_j = j_prep.read_su_gather(p)
    np.testing.assert_array_equal(nat, ref)
    assert dt_n == dt_j
    # the numpy fallback, as when no compiler is there
    monkeypatch.setattr(native_su, "read_su_native", lambda path: None)
    fb, dt_f = prep.read_su_gather(p)
    np.testing.assert_array_equal(fb, d)
    assert dt_f == dt_n
    with open(p, "ab") as f:
        f.write(b"\0" * 7)  # no byte order tiles the file now
    with pytest.raises(ValueError):
        prep.read_su_gather(p)


@pytest.mark.parametrize("order", ["<", ">"])
def test_su_observed_ingestion_matches_jax(tmp_path, order):
    rng = np.random.default_rng(0)
    ns_samp, ntr, nshot = 50, 7, 3
    root = tmp_path / "su"
    root.mkdir()
    want = {}
    for comp in ("x", "y"):
        for k in range(1, nshot + 1):
            want[(comp, k)] = rng.standard_normal(
                (ntr, ns_samp)).astype(np.float32)
            _write_su(root / f"seis_{comp}.su.shot{k}", order,
                      want[(comp, k)], 1500)
    shape, dt_s = prep.prepare_su_observed(str(root), str(tmp_path / "p"))
    j_shape, j_dt = j_prep.prepare_su_observed(str(root),
                                               str(tmp_path / "j"))
    assert shape == j_shape == (nshot, ns_samp, ntr) and dt_s == j_dt
    for letter in "AD":
        a = np.load(tmp_path / "p" / f"train{letter}" / "0.npy")
        np.testing.assert_array_equal(
            a, np.load(tmp_path / "j" / f"train{letter}" / "0.npy"))
    a = np.load(tmp_path / "p" / "trainA" / "0.npy")
    np.testing.assert_array_equal(a[0], want[("x", 1)].T)
    os.remove(root / "seis_y.su.shot3")
    with pytest.raises(ValueError):
        prep.prepare_su_observed(str(root), str(tmp_path / "bad"))


def test_grid_readers_match_jax(tmp_path):
    """.npy, flat .bin and SEG-Y (IEEE and IBM samples) recover the same
    grid as the JAX readers."""
    nz, nx = 30, 20
    m = np.random.default_rng(0).uniform(1500.0, 4000.0,
                                         (nz, nx)).astype(np.float32)
    np.save(tmp_path / "m.npy", m)
    m.tofile(tmp_path / "m.bin")
    np.testing.assert_array_equal(
        prep.read_velocity_grid(str(tmp_path / "m.npy")), m)
    np.testing.assert_array_equal(prep.read_velocity_grid(
        str(tmp_path / "m.bin"), bin_nz=nz, bin_nx=nx), m)
    for fmt in (5, 1):
        p = str(tmp_path / f"m{fmt}.segy")
        marmousi.write_segy_grid(p, m, fmt=fmt)
        got = prep.read_velocity_grid(p)
        np.testing.assert_array_equal(got, j_prep.read_segy_grid(p))
        np.testing.assert_allclose(got, m, rtol=0 if fmt == 5 else 1e-6)
    with pytest.raises(ValueError):
        prep.read_velocity_grid(str(tmp_path / "m.bin"))
    with pytest.raises(ValueError):
        prep.read_velocity_grid(str(tmp_path / "m.bin"), bin_nz=7, bin_nx=7)
    u = np.random.default_rng(2).integers(0, 2**32, 1000, dtype=np.uint64)
    np.testing.assert_array_equal(prep._ibm32_to_float(u),
                                  j_prep._ibm32_to_float(u))
    one = np.uint32((65 << 24) | (1 << 20))  # 1.0 = 16^1 * 0.0625
    assert prep._ibm32_to_float(np.asarray([one]))[0] == 1.0
    kms = prep.normalize_velocity(m / 1000.0)
    np.testing.assert_array_equal(kms, j_prep.normalize_velocity(m / 1000.0))


@pytest.mark.parametrize("shape,out", [
    ((30, 20), (60, 50)),      # enlarging both axes
    ((751, 2301), (151, 200)),  # Marmousi's shrink to the acoustic grid
    ((751, 2301), (100, 300)),  # ... and to the elastic one
    ((40, 30), (40, 90)),      # one axis kept, one enlarged
    ((64, 48), (17, 48)),      # one axis shrunk, one kept
    ((20, 60), (45, 25)),      # one enlarged, one shrunk
])
def test_resample_grid_matches_jax_image_resize(shape, out):
    rng = np.random.default_rng(sum(shape))
    m = rng.uniform(1500.0, 4700.0, shape).astype(np.float32)
    got = prep.resample_grid(m, *out)
    ref = np.asarray(jax.image.resize(m, out, method="bilinear"))
    assert got.shape == out and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)


def test_resample_weights_antialias_when_shrinking():
    w = prep.resize_weights(751, 151)
    ref = np.asarray(jax.image.resize(np.eye(751, dtype=np.float32),
                                      (751, 151), "bilinear"))
    np.testing.assert_allclose(w, ref, rtol=0, atol=1e-6)
    # the kernel spans ~5 input rows a side (fewer at the clipped edges)
    assert (w > 0).sum(axis=0)[1:-1].min() >= 9
    np.testing.assert_allclose(w.sum(axis=0), 1.0, rtol=1e-6)


@pytest.mark.parametrize("builder,args", [
    ("canonical_marmousi_vp", dict(nz=96, nx=120)),
    ("canonical_marmousi_vp", dict(nz=64, nx=80, seed=7)),
    ("canonical_seam_vp", dict(nz=120, nx=160)),
    ("canonical_seam_vp", dict(nz=60, nx=90, seed=3)),
])
def test_canonical_grids_bit_equal_to_jax(builder, args):
    got = getattr(marmousi, builder)(**args)
    np.testing.assert_array_equal(got, getattr(j_marmousi, builder)(**args))
    assert got.dtype == np.float32


def test_float_to_ibm32_and_segy_bytes_match_jax(tmp_path):
    f = np.random.default_rng(4).standard_normal(2000) * 1e4
    np.testing.assert_array_equal(marmousi._float_to_ibm32(f),
                                  j_marmousi._float_to_ibm32(f))
    vp = marmousi.canonical_marmousi_vp(40, 30)
    for fmt in (1, 5):
        marmousi.write_segy_grid(str(tmp_path / "p.segy"), vp, fmt=fmt)
        j_marmousi.write_segy_grid(str(tmp_path / "j.segy"), vp, fmt=fmt)
        assert ((tmp_path / "p.segy").read_bytes()
                == (tmp_path / "j.segy").read_bytes())


def test_marmousi_cli_writes_the_grid(tmp_path):
    out = str(tmp_path / "m.segy")
    marmousi.main(["--out", out, "--nz", "40", "--nx", "50", "--fmt", "1"])
    np.testing.assert_allclose(prep.read_segy_grid(out),
                               marmousi.canonical_marmousi_vp(40, 50),
                               rtol=1e-6)
