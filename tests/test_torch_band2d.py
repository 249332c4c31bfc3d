"""The port's corner gather and nodal assembly (ops/band2d.py, plain
versions; on CPU tensors the wrappers run them) against the JAX package:
direct indexing and the band engine for the gather, assembly.node_sum bit
for bit and the band engine at its own tolerance for the assembly, and one
case against the Pallas kernels in interpret mode.  Triangles and tets,
float32 and float64, inputs from a numpy seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynearthsol_tpu.ops import band2d as jband
from dynearthsol_tpu.ops.assembly import node_sum as jnode_sum
from dynearthsol_tpu_torch.mesh.topology import finish_topology
from dynearthsol_tpu_torch.ops import band2d as tband
from dynearthsol_tpu_torch.ops.assembly import node_sum as tnode_sum
from test_band2d import _mesh, _support, _tet_mesh

MESHES = {"tri": _mesh, "tet": _tet_mesh}
DTYPES = {"f32": (np.float32, torch.float32),
          "f64": (np.float64, torch.float64)}


@pytest.fixture(scope="module", params=list(MESHES))
def mesh(request):
    conn, nnode = MESHES[request.param]()
    return conn, nnode, tband.build_tables(conn, nnode), \
        _support(conn, nnode)


def _nodal(nnode, k, npdt, seed):
    return np.random.default_rng(seed).standard_normal((nnode, k)) \
        .astype(npdt)


def _elem(nelem, npe, k, npdt, seed):
    """(k, npe, nelem) element pack and the same values as the JAX
    engines' [corner][field] columns and node_sum's (nelem, npe, k)."""
    cols = np.random.default_rng(seed).standard_normal((k, npe, nelem)) \
        .astype(npdt)
    slot_cols = [tuple(jnp.asarray(cols[j, c]) for j in range(k))
                 for c in range(npe)]
    return cols, slot_cols, np.ascontiguousarray(cols.transpose(2, 1, 0))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("k", [6, 2])
def test_gather_matches_indexing_and_band_engine(mesh, dt, k):
    conn, nnode, bt, _ = mesh
    npdt, tdt = DTYPES[dt]
    pack = _nodal(nnode, k, npdt, 0)
    got = tband.cgather(torch.from_numpy(pack), bt).numpy()
    assert got.shape == (k, conn.shape[1], conn.shape[0])
    assert got.dtype == npdt
    for c in range(conn.shape[1]):
        np.testing.assert_array_equal(got[:, c], pack[conn[:, c]].T)
    if dt == "f32":
        jbt = jband.build_band_tables(conn, nnode)
        want = jband.gather_corners(
            jband.pack_nodal([jnp.asarray(pack[:, j]) for j in range(k)],
                             jbt), jbt, k)
        for c in range(conn.shape[1]):
            for j in range(k):
                np.testing.assert_allclose(got[j, c],
                                           np.asarray(want[c][j]),
                                           rtol=0, atol=0)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("k", [2, 5])
def test_scatter_equals_node_sum(mesh, dt, k):
    """Bit for bit against the JAX package's node_sum and the port's, and
    within the band engine's own tolerance (tests/test_band2d.py:77-79)
    of the band engine."""
    conn, nnode, bt, (gidx, gmask) = mesh
    npdt, tdt = DTYPES[dt]
    cols, slot_cols, contrib = _elem(conn.shape[0], conn.shape[1], k, npdt, 1)
    got = tband.asm_pack(torch.from_numpy(cols), bt).numpy()
    want = np.asarray(jnode_sum(jnp.asarray(contrib), gidx, gmask))
    assert got.dtype == want.dtype == npdt
    np.testing.assert_array_equal(got, want)
    topo = finish_topology(conn.shape[1] - 1, conn,
                           np.zeros(nnode, np.uint32))
    mine = tnode_sum(torch.from_numpy(contrib),
                     torch.from_numpy(topo.gather_idx),
                     torch.from_numpy(topo.gather_mask)).numpy()
    np.testing.assert_array_equal(got, mine)
    if dt == "f32":
        band = jband.scatter_corners(slot_cols,
                                     jband.build_band_tables(conn, nnode))
        for j in range(k):
            np.testing.assert_allclose(got[:, j], np.asarray(band[j]),
                                       rtol=2e-6, atol=2e-5)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("k,kg", [(2, 1), (1, 1), (3, 2)])
def test_scatter_gather_equals_node_sum_then_indexing(mesh, dt, k, kg):
    conn, nnode, bt, (gidx, gmask) = mesh
    npdt, tdt = DTYPES[dt]
    npe = conn.shape[1]
    cols, slot_cols, contrib = _elem(conn.shape[0], npe, k, npdt, 2)
    sums, gath = tband.asm_gather(torch.from_numpy(cols), bt, kg)
    sums, gath = sums.numpy(), gath.numpy()
    want = np.asarray(jnode_sum(jnp.asarray(contrib), gidx, gmask))
    np.testing.assert_array_equal(sums, want)
    assert gath.shape == (kg, npe, conn.shape[0])
    for c in range(npe):
        np.testing.assert_array_equal(gath[:, c], want[conn[:, c], :kg].T)
    if dt == "f32":
        bsums, bgath = jband.scatter_gather_corners(
            slot_cols, jband.build_band_tables(conn, nnode), kg)
        for j in range(k):
            np.testing.assert_allclose(sums[:, j], np.asarray(bsums[j]),
                                       rtol=2e-6, atol=2e-5)
        for c in range(npe):
            for j in range(kg):
                np.testing.assert_allclose(gath[j, c],
                                           np.asarray(bgath[c][j]),
                                           rtol=2e-6, atol=2e-5)


def test_against_pallas_kernels_in_interpret_mode(monkeypatch):
    """The TPU kernels themselves, run as tests/test_band2d.py:102-104
    runs them on the CPU, on triangles: the gather at atol 0 (its one-hot
    selection is exact), the assembly at rtol 2e-6, atol 2e-5 (window
    order).  One case: each interpreted call takes several seconds
    whatever the mesh size, and the tests above hold triangles and tets
    against the kernels' jnp twins."""
    monkeypatch.setattr(jband, "INTERPRET", True)
    conn, nnode = _mesh()
    bt = tband.build_tables(conn, nnode)
    jbt = jband.build_band_tables(conn, nnode)
    k = 4
    pack = _nodal(nnode, k, np.float32, 3)
    got = tband.cgather(torch.from_numpy(pack), bt).numpy()
    want = jband.gather_corners_tpu(
        jband.pack_nodal([jnp.asarray(pack[:, j]) for j in range(k)], jbt),
        jbt, k)
    for c in range(3):
        for j in range(k):
            np.testing.assert_allclose(got[j, c], np.asarray(want[c][j]),
                                       rtol=0, atol=0)
    k = 3
    cols, slot_cols, _ = _elem(conn.shape[0], 3, k, np.float32, 4)
    sums = tband.asm_pack(torch.from_numpy(cols), bt).numpy()
    want_s = jband.scatter_corners_tpu(slot_cols, jbt)
    for j in range(k):
        np.testing.assert_allclose(sums[:, j], np.asarray(want_s[j]),
                                   rtol=2e-6, atol=2e-5)


def test_tables_follow_the_topology_support(mesh):
    """The CSR rows list each node's slots in the order of the support
    table of mesh/topology (node_sum's order), renumbered corner-major,
    for a numbering that is not band-friendly too."""
    conn, nnode, _, _ = mesh
    perm = np.random.default_rng(5).permutation(nnode)
    for cn in (conn, perm[conn].astype(np.int32)):
        bt = tband.build_tables(cn, nnode)
        nelem, npe = cn.shape
        topo = finish_topology(npe - 1, cn, np.zeros(nnode, np.uint32))
        row_ptr, slots = bt.row_ptr.numpy(), bt.slots.numpy()
        assert row_ptr[-1] == nelem * npe
        np.testing.assert_array_equal(np.diff(row_ptr),
                                      topo.gather_mask.sum(axis=1))
        flat = topo.gather_idx[topo.gather_mask]      # e * npe + c
        np.testing.assert_array_equal(slots,
                                      (flat % npe) * nelem + flat // npe)
        np.testing.assert_array_equal(bt.conn_cm.numpy(),
                                      cn.T.reshape(-1))
        np.testing.assert_array_equal(bt.m_cols.numpy(), topo.gather_mask.T)


def test_wrappers_refuse_what_the_kernels_do_not_take(mesh):
    conn, nnode, bt, _ = mesh
    nelem, npe = conn.shape
    with pytest.raises(ValueError, match="kg"):
        tband.asm_gather(torch.zeros((2, npe, nelem)), bt, 3)
    for bad in (torch.zeros((nnode, 9)), torch.zeros((nnode + 1, 2)),
                torch.zeros((nnode, 4))[:, ::2],
                torch.zeros((nnode, 2), dtype=torch.float16)):
        with pytest.raises((ValueError, TypeError)):
            tband._check_nodal(bad, bt)
    for bad in (torch.zeros((9, npe, nelem)), torch.zeros((2, npe, nelem + 1)),
                torch.zeros((2, nelem, npe)).transpose(1, 2),
                torch.zeros((2, npe, nelem), dtype=torch.int32)):
        with pytest.raises((ValueError, TypeError)):
            tband._check_elem(bad, bt)
    with pytest.raises(TypeError, match="conn_cm"):
        tband._check_tables(bt, torch.device("meta"))
