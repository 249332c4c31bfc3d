"""The port's corner gather and nodal assembly (ops/band2d.py, plain
versions; on CPU tensors the wrappers run them) against the JAX package:
direct indexing and the band engine for the gather, assembly.node_sum bit
for bit and the band engine at its own tolerance for the assembly, and one
case against the Pallas kernels in interpret mode.  Triangles and tets,
float32 and float64, inputs from a numpy seed.  The gather kernel's tile
tables against a recomputation, and its tile loop (stage a window, read
through relative ids; unstaged tiles directly) as a PyTorch twin, bit
for bit against the plain version.
"""

import dataclasses

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


# ------------------------------------------- the assembly kernel's order

def _delaunay():
    from dynearthsol_tpu_torch.mesh.generate import (renumber_mesh,
                                                     unstructured_box_2d)
    m = unstructured_box_2d(16e3, 8e3, 500.0)
    coord, conn, _ = renumber_mesh(m.coord, m.connectivity)
    return np.asarray(conn, np.int32), coord.shape[0]


def _fan(n=40):
    """n triangles around node 0: a node of degree n."""
    i = np.arange(1, n + 1)
    return np.stack([np.zeros(n, int), i, i + 1], 1).astype(np.int32), n + 2


ROW_MESHES = {**MESHES, "delaunay": _delaunay, "fan": _fan}


def _node_twin(cols, bt):
    """csrc/band2d.cu asm_pack_kernel in PyTorch: one thread per node, its
    row's slots taken in row order, each value added to a sum that starts
    from +0.0, and nothing added past the row's end (the plain version adds
    +0.0 there instead).  The kernel loads the first UNROLL slots at once
    and the rest of a longer row one by one; the order is the same."""
    k = cols.shape[0]
    flat = cols.reshape(k, -1)
    b, e = bt.row_ptr[:-1].long(), bt.row_ptr[1:].long()
    acc = torch.zeros((bt.nnode, k), dtype=cols.dtype)
    for d in range(max(tband.UNROLL, int((e - b).max()))):
        live = b + d < e
        v = flat[:, bt.slots.long()[torch.where(live, b + d, 0)]].t()
        acc = torch.where(live[:, None], acc + v, acc)
    return acc


def test_unroll_covers_the_delaunay_rows():
    """UNROLL (the slots the kernel loads at once) covers every row of the
    Delaunay meshes; the 5-tet grid's rows run past it (the kernel's
    one-by-one tail)."""
    for make, within in ((_mesh, True), (_delaunay, True),
                         (_tet_mesh, False)):
        conn, nnode = make()
        deg = np.bincount(conn.ravel(), minlength=nnode)
        assert (deg.max() <= tband.UNROLL) == within


# ------------------------------------------------ the gather's tiles

def _shuffled(make):
    def f():
        conn, nnode = make()
        perm = np.random.default_rng(8).permutation(nnode)
        return perm[conn].astype(np.int32), nnode
    return f


def _ends_swapped(make):
    """The first and last two node ids swapped: the tiles that hold them
    span the whole numbering."""
    def f():
        conn, nnode = make()
        perm = np.arange(nnode)
        perm[[0, 1, nnode - 2, nnode - 1]] = [nnode - 1, nnode - 2, 1, 0]
        return perm[conn].astype(np.int32), nnode
    return f


TILE_MESHES = {"tri": _mesh, "tri_shuffled": _shuffled(_mesh),
               "mixed": _ends_swapped(_mesh), "tet": _tet_mesh,
               "delaunay": _delaunay}
# (tile, w_max): the kernel's own, and small tiles whose windows a narrow
# cap splits into staged and unstaged ones
TILINGS = [(tband.TILE, tband.W_MAX), (64, 100)]


def _tables(conn, nnode, tile, w_max):
    """build_tables' tables, their tile fields for (tile, w_max)."""
    bt = tband.build_tables(conn, nnode)
    if (tile, w_max) == (tband.TILE, tband.W_MAX):
        return bt
    lo, w, staged, rel = tband.tile_windows(
        bt.conn_cm.numpy().astype(np.int64).reshape(bt.npe, bt.nelem),
        tile, w_max)
    return dataclasses.replace(
        bt, tile_lo=torch.from_numpy(lo).int(),
        tile_w=torch.from_numpy(w).int(),
        tile_staged=torch.from_numpy(staged),
        rel_cm=torch.from_numpy(rel.reshape(-1)),
        win_rows=int(w[staged].max(initial=0)))


def _tile_twin(pack, bt, tile, kg):
    """csrc/band2d.cu gather_corners_kernel's tile loop in PyTorch, the
    first kg columns of pack: a staged tile copies its window's whole
    rows, then reads each slot through its relative id; an unstaged tile
    reads the pack through the node ids."""
    k = pack.shape[1]
    out = torch.empty((kg, bt.npe, bt.nelem), dtype=pack.dtype)
    conn = bt.conn_cm.long().view(bt.npe, bt.nelem)
    rel = bt.rel_cm.long().view(bt.npe, bt.nelem)
    for t in range(bt.tile_lo.numel()):
        e = slice(t * tile, (t + 1) * tile)
        if bt.tile_staged[t]:
            lo, w = int(bt.tile_lo[t]), int(bt.tile_w[t])
            win = pack.reshape(-1)[lo * k:(lo + w) * k].clone().view(w, k)
            rows = win[rel[:, e]]
        else:
            rows = pack[conn[:, e]]                       # (npe, n, k)
        out[:, :, e] = rows[..., :kg].permute(2, 0, 1)
    return out


def check_gather_matches_indexing_and_band_engine(mesh, dt, k):
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


def check_node_twin_equals_plain_and_node_sum(kind, dt):
    """The kernel's per-node order gives scatter_corners' and the port's
    node_sum's sums bit for bit, on rows within UNROLL (triangles) and
    beyond it (the 5-tet grid's 32, the fan's 40), for a node numbering
    that is not local too, with signed zeros among the values."""
    conn, nnode = ROW_MESHES[kind]()
    npdt, tdt = DTYPES[dt]
    bits = torch.int32 if tdt == torch.float32 else torch.int64
    perm = np.random.default_rng(6).permutation(nnode)
    for cn in (conn, perm[conn]):
        bt = tband.build_tables(cn, nnode)
        topo = finish_topology(cn.shape[1] - 1, cn,
                               np.zeros(nnode, np.uint32))
        for k in (1, 2, 5, 8):
            rng = np.random.default_rng(k)
            cols = rng.standard_normal((k, cn.shape[1], cn.shape[0]))
            cols[rng.random(cols.shape) < 0.1] = -0.0
            cols = cols.astype(npdt)
            contrib = np.ascontiguousarray(cols.transpose(2, 1, 0))
            got = _node_twin(torch.from_numpy(cols), bt)
            for want in (tband.scatter_corners(torch.from_numpy(cols), bt),
                         tnode_sum(torch.from_numpy(contrib),
                                   torch.from_numpy(topo.gather_idx),
                                   torch.from_numpy(topo.gather_mask))):
                # bits, so that -0.0 and +0.0 differ too
                assert torch.equal(got.view(bits), want.view(bits)), k


def check_scatter_gather_equals_node_sum_then_indexing(mesh, dt, k, kg):
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


def check_scatter_equals_node_sum(mesh, dt, k):
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


def check_tile_tables_recomputed(kind, tiling):
    """The gather's tile fields against a recomputation tile by tile: every
    slot's base + relative id is its node, every staged window is within
    the cap, the bases are aligned for a bulk copy at every row length the
    wrappers pass, and win_rows is the widest staged window."""
    tile, w_max = tiling
    conn, nnode = TILE_MESHES[kind]()
    bt = _tables(conn, nnode, tile, w_max)
    nelem, npe = conn.shape
    ntiles = -(-nelem // tile)
    lo, w = bt.tile_lo.numpy(), bt.tile_w.numpy()
    staged, rel = bt.tile_staged.numpy(), bt.rel_cm.numpy()
    assert bt.tile_lo.dtype == bt.tile_w.dtype == torch.int32
    assert bt.rel_cm.dtype == torch.int16 and rel.size == npe * nelem
    assert lo.shape == w.shape == staged.shape == (ntiles,)
    rel = rel.reshape(npe, nelem).astype(np.int64)
    for t in range(ntiles):
        e = slice(t * tile, (t + 1) * tile)
        nodes = conn[e].T.astype(np.int64)                # (npe, tile)
        assert lo[t] % tband.ALIGN == 0
        assert lo[t] <= nodes.min() < lo[t] + tband.ALIGN
        assert lo[t] + w[t] == nodes.max() + 1 <= nnode
        assert staged[t] == (w[t] <= w_max)
        if staged[t]:
            np.testing.assert_array_equal(lo[t] + rel[:, e], nodes)
        else:
            assert not rel[:, e].any()
        for ld in range(1, tband.KMAX + 1):
            for itemsize in (4, 8):
                assert lo[t] * ld * itemsize % 16 == 0
    assert bt.win_rows == max(w[staged], default=0) <= w_max
    if kind == "tri_shuffled" and tile == 64:
        assert not staged.any()
    if kind == "mixed" and tile == 64:
        assert 0 < staged.sum() < ntiles


def check_tile_twin_equals_plain(kind, dt, tiling):
    """The kernel's tile loop gives gather_corners' result bit for bit, for
    cgather (kg = k) and asm_gather's gather (kg = 1 of k), with signed
    zeros and NaN payloads among the values."""
    tile, w_max = tiling
    conn, nnode = TILE_MESHES[kind]()
    bt = _tables(conn, nnode, tile, w_max)
    npdt, tdt = DTYPES[dt]
    bits = torch.int32 if tdt == torch.float32 else torch.int64
    nan = 0x7FC00123 if tdt == torch.float32 else 0x7FF8000000000123
    for k in (1, 2, 6, 8):
        rng = np.random.default_rng(k)
        pack = torch.from_numpy(rng.standard_normal((nnode, k)).astype(npdt))
        pack[torch.from_numpy(rng.random((nnode, k)) < 0.1)] = -0.0
        pack.view(bits)[torch.from_numpy(rng.random((nnode, k)) < 0.05)] = nan
        for kg in sorted({1, k}):
            want = tband.gather_corners(pack[:, :kg].contiguous(), bt)
            got = _tile_twin(pack, bt, tile, kg)
            assert torch.equal(got.view(bits), want.view(bits)), (k, kg)
