"""Association of the port (panovlm_tpu_torch/models/association.py) against
the JAX pair functions on features the JAX package extracted, carried across
with panovlm_tpu_torch.interop.

Which JAX path: the KERNEL path (`use_kernel=True`, the Pallas KNN kernels in
interpret mode, monkeypatched as tests/test_pallas_knn.py does), which is
exact KNN like the port's. The default XLA path packs column indices into
low mantissa bits and differs from exact KNN on near-tie slots (ROADMAP F3).

Tolerance: masks exact; line points/directions and planes within atol 1e-4
on associated rows (world transforms and plane fits sum in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthetic
import panovlm_tpu.ops.pallas.knn as jknn
from panovlm_tpu import pipeline
from panovlm_tpu.models import association as jassoc
from panovlm_tpu.sensors import velodyne as jvd
from panovlm_tpu_torch import interop
from panovlm_tpu_torch.models import association as tassoc

torch.set_num_threads(2)

PAIRS = ((0, 1), (1, 0), (1, 2))


@pytest.fixture(scope="module")
def setup():
    scans, _ = synthetic.make_trajectory_scans(n_scans=3, h_steps=900)
    batch = pipeline.extract_all_features(
        [jvd.preprocess_cloud(s)[0] for s in scans], cap=16384)
    batch_np = {k: np.asarray(v) for k, v in batch.items()}
    rng = np.random.default_rng(0)
    poses = np.zeros((3, 6), np.float32)
    poses[:, 3] = -0.15 * np.arange(3)
    poses[:, 4] = -0.02 * np.arange(3)
    poses[1:] += rng.normal(size=(2, 6)).astype(np.float32) * 0.003
    return batch_np, poses


@pytest.fixture(scope="module")
def jax_kernel_path(setup):
    batch_np, poses = setup
    orig = jknn.knn_pallas, jknn.knn_ring_pallas
    jknn.knn_pallas = functools.partial(orig[0], interpret=True)
    jknn.knn_ring_pallas = functools.partial(orig[1], interpret=True)
    try:
        out = []
        for r, n in PAIRS:
            fr = {k: jnp.asarray(v[r]) for k, v in batch_np.items()}
            fn = {k: jnp.asarray(v[n]) for k, v in batch_np.items()}
            p2l = jassoc.associate_point2line_pair(fr, fn, poses[r], poses[n],
                                                   use_kernel=True)
            p2p = jassoc.associate_point2plane_pair(fr, fn, poses[r], poses[n],
                                                    use_kernel=True)
            l2l = jassoc.associate_line2line_pair(p2l, fr, fn)
            out.append(jax.tree_util.tree_map(np.asarray,
                                              {"p2l": p2l, "p2p": p2p, "l2l": l2l}))
    finally:
        jknn.knn_pallas, jknn.knn_ring_pallas = orig
    return out


@pytest.fixture(scope="module")
def port(setup):
    batch_np, poses = setup
    batch = interop.features_from_numpy(batch_np)
    tp = interop.poses_from_numpy(poses)
    pr = torch.tensor([p[0] for p in PAIRS])
    pn = torch.tensor([p[1] for p in PAIRS])
    fr = {k: v[pr] for k, v in batch.items()}
    fn = {k: v[pn] for k, v in batch.items()}
    p2l = tassoc.associate_point2line_pair(fr, fn, tp[pr], tp[pn])
    p2p = tassoc.associate_point2plane_pair(fr, fn, tp[pr], tp[pn])
    l2l = tassoc.associate_line2line_pair(p2l, fr, fn)
    return {"p2l": p2l, "p2p": p2p, "l2l": l2l}


@pytest.mark.parametrize("family,fields", [
    ("p2l", ("point", "line_pt", "line_dir", "seg_r")),
    ("p2p", ("point", "plane")),
    ("l2l", ("dir_n", "dir_r", "seg_r")),
])
def test_pair_functions_match_jax_kernel_path(jax_kernel_path, port, family, fields):
    for m, ref_all in enumerate(jax_kernel_path):
        ref = ref_all[family]
        mask = port[family]["mask"][m].numpy()
        assert (mask == ref["mask"]).all(), (family, m, int((mask != ref["mask"]).sum()))
        assert mask.sum() > 0, (family, m)
        for key in fields:
            out = port[family][key][m].numpy()
            np.testing.assert_allclose(out[mask], ref[key][mask], atol=1e-4,
                                       err_msg=f"{family}/{key} pair {m}")


def test_associate_all_pairs_matches_pair_functions(setup, port):
    batch_np, poses = setup
    batch = interop.features_from_numpy(batch_np)
    out = tassoc.associate_all_pairs(batch, interop.poses_from_numpy(poses),
                                     torch.tensor([p[0] for p in PAIRS]),
                                     torch.tensor([p[1] for p in PAIRS]))
    for fam in ("p2l", "p2p", "l2l"):
        for key, val in out[fam].items():
            assert torch.equal(val, port[fam][key]), (fam, key)


def test_find_neighbors_matches_jax():
    rng = np.random.default_rng(1)
    poses = np.zeros((12, 6), np.float32)
    poses[:, 3:] = rng.normal(size=(12, 3)).astype(np.float32)
    valid = np.ones(12, bool)
    valid[5] = False
    ref = jassoc.find_neighbors(jnp.asarray(poses), valid, k=3)
    out = tassoc.find_neighbors(torch.from_numpy(poses), valid, k=3)
    assert all((a == b).all() for a, b in zip(ref, out))


def test_interop_rejects_incomplete_batches(setup):
    batch_np, poses = setup
    with pytest.raises(KeyError):
        interop.features_from_numpy({k: v for k, v in batch_np.items() if k != "flat"})
    with pytest.raises(ValueError):
        interop.poses_from_numpy(poses[:, :5])
