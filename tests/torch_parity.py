"""Shared set-up of the ``test_torch_*`` parity tests: data made from a
seed with numpy, JAX forests, and their carry-over into the PyTorch port
(``rptree_tpu_torch``) through the checkpoint arrays."""

import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rptree_tpu as rt
from rptree_tpu.models.forest import _sub_pack_tables
from rptree_tpu.utils.io import _header
from rptree_tpu_torch import forest_from_numpy
from rptree_tpu_torch.ops.grouped_kernel import untied


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per test module: the suite runs in several
    worker processes at once."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def clustered(seed, n, dim, centers, sigma, n_queries):
    """Gaussian mixture (the clustered cell's data family) and queries
    that are dataset points plus half-sigma noise, both f32."""
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(centers, dim)).astype(np.float32)
    x = (c[rng.integers(0, centers, size=n)]
         + sigma * rng.normal(size=(n, dim))).astype(np.float32)
    q = (x[rng.integers(0, n, size=n_queries)]
         + 0.5 * sigma * rng.normal(size=(n_queries, dim))).astype(np.float32)
    return x, q


def jax_forest(x, seed=7, n_trees=4, min_leaf=32, payloads=None):
    cfg = rt.rp_tree_cfg(min_leaf, x.shape[0], x.shape[1])
    return rt.forest_batch(seed, cfg.max_depth, min_leaf, n_trees,
                           cfg.proj_nz_density, x, payloads=payloads)


def carry(fj, device="cpu"):
    """The port's forest from a JAX forest's header, arrays, payloads and
    seed."""
    arrays = {k: np.array(getattr(fj.arrays, k))
              for k in ("r", "thr", "mgl", "mgh", "perm")}
    if hasattr(fj.x, "cols"):  # an ELL dataset
        arrays["x_cols"], arrays["x_vals"] = (np.array(fj.x.cols),
                                              np.array(fj.x.vals))
    else:
        arrays["x"] = np.array(fj.x)
    return forest_from_numpy(_header(fj), arrays, device=device,
                             payloads=fj.payloads)


def knn_agree(got, want, rtol=1e-5, last=True):
    """The port's ``(dists, ids)`` against the JAX package's, both ``[B,
    k]`` in ascending order: the same shapes and padding, distances within
    ``rtol`` (relative, and absolute below 1), and ids equal wherever
    JAX's distance is apart from its row neighbours by more than ``rtol``
    (``untied``), where two correct summation orders cannot swap them.
    ``last=False`` leaves the k-th id out: its neighbour past the k-th,
    which neither result shows, may tie it."""
    (dt, it), (dj, ij) = got, want
    dt, it = dt.numpy(), it.numpy()
    dj, ij = np.array(dj), np.array(ij)
    assert it.dtype == np.int32 and dt.dtype == np.float32
    assert dt.shape == dj.shape
    np.testing.assert_array_equal(np.isinf(dt), np.isinf(dj))
    np.testing.assert_array_equal(it < 0, ij < 0)
    fin = np.isfinite(dj)
    np.testing.assert_allclose(dt[fin], dj[fin], rtol=rtol, atol=rtol)
    chk = untied(torch.as_tensor(dj), rtol).numpy()
    if not last:
        chk[:, -1] = False
    np.testing.assert_array_equal(it[chk], ij[chk])
    assert chk.any()


# the dense layouts of ``pack_leaves`` beside f32 / bf16 / int8 blocks, by
# name: block dtype ("bf16", "int8" or absent for f32) and the rest of the
# request
LAYOUTS = {
    "f32_sub4_kmeans": dict(sub_block=4),
    "f32_sub2_proj": dict(sub_block=2, sub_split="proj"),
    "f32_sub3": dict(sub_block=3),                    # kmeans falls to proj
    "bf16_sub2": dict(dtype="bf16", sub_block=2),
    "int8_sub4": dict(dtype="int8", sub_block=4),
    "int8_centered": dict(dtype="int8", centered=True),
    "int8_centered_slack": dict(dtype="int8", centered=True, slack=8),
    "int8_centered_sub8": dict(dtype="int8", centered=True, sub_block=8),
    "shared_f32": dict(store="shared"),
    "shared_bf16": dict(dtype="bf16", store="shared"),
}
JAX_DTYPES = {None: None, "bf16": jnp.bfloat16, "int8": jnp.int8}
TORCH_DTYPES = {None: None, "bf16": torch.bfloat16, "int8": torch.int8}


def jax_r_sub(fj):
    """The JAX package's sub-block ordering direction for ``fj`` (its
    threefry draw, salt 987), which the port takes as ``r_sub``."""
    lens = np.asarray(fj.plan.leaf_len)
    return np.array(_sub_pack_tables(fj.seed, fj.dim, lens, 8, 2)[0])


def pack_twins(fj, ft, layout):
    """Pack a JAX forest and its carried twin in ``layout`` (a
    :data:`LAYOUTS` entry), the port with JAX's ``r_sub``."""
    kw = dict(layout)
    dtype = kw.pop("dtype", None)
    fj.pack_leaves(dtype=JAX_DTYPES[dtype], **kw)
    r_sub = jax_r_sub(fj) if kw.get("sub_block", 1) > 1 else None
    ft.pack_leaves(dtype=TORCH_DTYPES[dtype], **kw, r_sub=r_sub)


# -- the examples' tests (``test_torch_examples*.py``) -----------------------

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")
if EXAMPLES not in sys.path:
    sys.path.insert(0, EXAMPLES)


@pytest.fixture
def cpu_examples(monkeypatch):
    """The examples run on the CPU (``RPTREE_EXAMPLE_DEVICE=cpu``)."""
    monkeypatch.setenv("RPTREE_EXAMPLE_DEVICE", "cpu")


def labels(text):
    """Each printed line with its numbers as ``#``, its runs of blanks as
    one and none after a ``=`` (padding): the labels, in order."""
    return [" ".join(re.sub(r"\d+(\.\d+)?", "#",
                            re.sub(r"=\s+", "=", line)).split())
            for line in text.splitlines()]


def recalls(text):
    """Every recall an example printed, in order."""
    return [float(m) for m in re.findall(
        r"recall(?:@10| fold-only| rebuilt)? (\d\.\d+)", text)]
