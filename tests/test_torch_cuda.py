"""The CUDA kernels of the PyTorch port (csrc/fused2d.cu, csrc/fused3d.cu,
csrc/band2d.cu) against their plain PyTorch versions, on the card (the
checks of chip_smoke.py phases 3, 4, 8-9 and 12 at the 16 x 128-cell
2D, 128 x 16 x 8-cell 3D and small unstructured sizes), with the CPU
tests' tolerances; the 3D kernel against the plain version run on the CPU (see
_run3); the gather and assembly kernels with tolerance 0; the 2D chunk
kernel against its own one-step launches bit for bit.  Imports no JAX.
Skips where there is no CUDA device; on the card run it as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import dynearthsol_tpu_torch as des
from dynearthsol_tpu_torch.mesh.generate import (regular_grid_3d,
                                                 renumber_mesh,
                                                 unstructured_box_2d)
from dynearthsol_tpu_torch.ops import band2d, flat3d, fused2d, fused3d
from dynearthsol_tpu_torch.state import FIELD_NAMES
from torch_cases import (BOUNDARY3, FLAT_FIELDS, STEP3_CASES,
                         assert_evp3_one_step_close,
                         assert_evp_one_step_close, assert_maxwell3_close,
                         assert_maxwell_close, assert_resident_matches_tiled,
                         flat3d_cfg, flat_cfg, make_sim3d_cfg, make_sim_cfg,
                         multimat3d_cfg, production_cfg, rel_err)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def get(s, f):
    return getattr(s, f).cpu().numpy()


def _run(cfg, n, resident, plain):
    sim = des.Simulation(des.param_from_dict(cfg), device="cuda")
    P = fused2d.make_plan(sim.param, sim.ctx, sim.device,
                          sim.compensation_pressure)
    out = fused2d.run_chunk(P, sim.ctx, sim.state, n, resident, plain)
    torch.cuda.synchronize()
    return out


def _counts():
    return (fused2d.fused_chunk.launches, fused2d.dt_refresh.launches,
            fused2d.fused_step_plain.calls, fused2d.dt_refresh_plain.calls)


def test_maxwell_10_steps(cuda):
    """The tiled runner: one launch of the chunk kernel per step (n = 1),
    no dt_refresh launch."""
    cfg = make_sim_cfg(mat={"rheology_type": "maxwell"})
    before = _counts()
    out = _run(cfg, 10, False, False)
    assert _counts() == (before[0] + 10, *before[1:])
    assert_maxwell_close(_run(cfg, 10, False, True), out, get)


def test_evp_one_step(cuda):
    cfg = make_sim_cfg()
    assert_evp_one_step_close(_run(cfg, 1, False, True),
                              _run(cfg, 1, False, False), get)


def test_resident_matches_tiled(cuda):
    cfg = make_sim_cfg()
    tiled = _run(cfg, 25, False, False)
    before = _counts()
    res = _run(cfg, 25, True, False)
    assert _counts() == (before[0] + 1, *before[1:])
    assert_resident_matches_tiled(tiled, res, get)


@pytest.mark.parametrize("cfg", [make_sim_cfg(), production_cfg()],
                         ids=["flagship_features", "production"])
def test_chunk_equals_one_step_launches(cuda, cfg):
    """A 25-step chunk in one launch against 25 one-step launches of the
    same kernel from the same buffers: every plane (with the production
    features dhacc and edv too), scal and the dt history equal bit for
    bit."""
    sim = des.Simulation(des.param_from_dict(cfg), device="cuda")
    P = fused2d.make_plan(sim.param, sim.ctx, sim.device,
                          sim.compensation_pressure)
    n = 25
    cb = fused2d.make_buffers(P, sim.ctx, sim.state, n, tiled=False)
    fused2d.fused_chunk(P, cb, n, tiled=False)
    sb = fused2d.make_buffers(P, sim.ctx, sim.state, n, tiled=False)
    for k in range(n):
        fused2d.fused_chunk(P, sb, 1, tiled=False, k=k)
    torch.cuda.synchronize()
    for i in range(fused2d.NE):
        assert torch.equal(cb.ein[i], sb.ein[i]), i
    for i, nm in enumerate(fused2d.N_SLOTS):
        assert torch.equal(cb.nin[i], sb.nin[i]), nm
    assert torch.equal(cb.scal, sb.scal)
    assert torch.equal(cb.dthist, sb.dthist)


def test_chunk_maxwell_10_steps(cuda):
    """The resident runner, 10 steps in one launch, against the plain
    version at the maxwell gate of the 2D tests (2e-4, force 1e-3)."""
    cfg = make_sim_cfg(mat={"rheology_type": "maxwell"})
    assert_maxwell_close(_run(cfg, 10, True, True), _run(cfg, 10, True, False),
                         get)


def test_2d_path_launches_once_per_chunk(cuda):
    """Simulation.run_steps on pallas2d_res: one launch of the chunk kernel
    per chunk, no dt_refresh launch, no call of a plain version."""
    sim = des.Simulation(des.param_from_dict(make_sim_cfg()), device="cuda")
    before = _counts()
    sim.run_steps(20, chunk=10)
    torch.cuda.synchronize()
    assert sim.step_path == "pallas2d_res"
    assert _counts() == (before[0] + 2, *before[1:])


def test_refused_launch_raises(cuda):
    """An error code of the C entry raises in the wrapper: it refuses a plan
    with more materials than the kernel holds (MAXMAT) before launching."""
    sim = des.Simulation(des.param_from_dict(make_sim_cfg()), device="cuda")
    P = fused2d.make_plan(sim.param, sim.ctx, sim.device,
                          sim.compensation_pressure)
    b = fused2d.make_buffers(P, sim.ctx, sim.state, 1, tiled=False)
    ip = P.ip.copy()
    ip[fused2d.IP_FIELDS.index("nmat")] = fused2d.MAXMAT + 1
    ip[fused2d.IP_FIELDS.index("uniform")] = 0
    before = _counts()
    with pytest.raises(RuntimeError, match="launch failed"):
        fused2d.fused_chunk(dataclasses.replace(P, ip=ip), b, 1, tiled=False)
    assert _counts() == before


def test_production_kernel_vs_plain(cuda):
    """The production instance (Winkler and water tractions, surface
    process 1, two materials; 16 x 128 cells) against the plain version on
    the card: one EVP step at the one-step gate (2e-6) on coord, stress,
    strain, plstrain, force, dhacc and edvacc_surf, the velocity at the
    scale of its increment dt f / m (tests/test_torch_production2d.py);
    10 maxwell steps in one chunk launch at the maxwell gate (2e-4, force
    1e-3), the surface accumulators included."""
    cfg = production_cfg()
    sim = des.Simulation(des.param_from_dict(cfg), device="cuda")
    ref, out = _run(cfg, 1, False, True), _run(cfg, 1, False, False)
    assert_evp_one_step_close(ref, out, get, fields=(
        "coord", "stress", "strain", "plstrain", "force", "dhacc",
        "edvacc_surf"))
    inc = sim.state.dt * (ref.force / sim.state.mass[:, None]).abs().max()
    assert float((ref.vel - out.vel).abs().max()) < 2e-6 * float(inc)
    assert float(out.dhacc.abs().max()) > 0
    cfg = production_cfg("maxwell")
    ref, out = _run(cfg, 10, True, True), _run(cfg, 10, True, False)
    assert_maxwell_close(ref, out, get)
    for f in ("dhacc", "edvacc_surf"):
        assert rel_err(get(ref, f), get(out, f)) < 2e-4, f


def test_initial_volume_is_the_kernels(cuda):
    sim = des.Simulation(des.param_from_dict(make_sim_cfg()), device="cuda")
    P = fused2d.make_plan(sim.param, sim.ctx, sim.device,
                          sim.compensation_pressure)
    b = fused2d.make_buffers(P, sim.ctx, sim.state, 1, tiled=False)
    b.scal[0] = 0.0
    fused2d.fused_chunk(P, b, 1, tiled=False)
    torch.cuda.synchronize()
    vol = fused2d._eslot("volume")
    assert torch.equal(b.ein[vol], b.eout[vol])


def _run3(cfg, n, plain):
    """n fused 3D steps: the kernel on the card, or the plain version on the
    CPU.  PyTorch on the card divides by a Python number as a product with
    its reciprocal, an ulp off true division for a third of the values,
    which flips exact ties of the EVP min-select; on the CPU it divides
    truly, as the kernel does."""
    sim = des.Simulation(des.param_from_dict(cfg),
                         device="cpu" if plain else "cuda")
    P = fused3d.make_plan(sim.param, sim.ctx, sim.device,
                          sim.compensation_pressure)
    out = fused3d.run_chunk(P, sim.ctx, sim.state, n, plain)
    torch.cuda.synchronize()
    return out


def _cfg3(**over):
    return make_sim3d_cfg(mesh={"ylength": 16e3}, **over)


def test_fused3d_maxwell_10_steps(cuda):
    cfg = _cfg3(mat={"rheology_type": "maxwell"}, ic={"weakzone_option": 0})
    before = (fused3d.fused3d_step.launches, fused2d.dt_refresh.launches,
              fused3d.fused3d_finalize.launches)
    out = _run3(cfg, 10, False)
    assert (fused3d.fused3d_step.launches, fused2d.dt_refresh.launches,
            fused3d.fused3d_finalize.launches) == (
        before[0] + 10, before[1] + 10, before[2] + 1)
    assert_maxwell3_close(_run3(cfg, 10, True), out, get)


def test_fused3d_evp_one_step(cuda):
    cfg = _cfg3(ic={"weakzone_option": 1})
    assert_evp3_one_step_close(_run3(cfg, 1, True), _run3(cfg, 1, False),
                               get)


@pytest.mark.parametrize("case", list(STEP3_CASES))
def test_fused3d_one_step_cases(cuda, case):
    cfg = _cfg3(ic={"weakzone_option": 1}, **STEP3_CASES[case])
    assert_evp3_one_step_close(_run3(cfg, 1, True), _run3(cfg, 1, False),
                               get)


def test_fused3d_multimat_vs_plain(cuda):
    """The mixed instance of the 3D kernel (two materials, the const pack)
    against the plain version on the CPU: 3 maxwell steps in the chunk
    form at the maxwell gate (1e-3, force 5e-3), one maxwell step at the
    one-step gate (1e-4, force 1e-3, log-viscosity median 0.02) over every
    value, and one EVP step at the one-step gate away from what its ties
    of equal nonzero invariants reach (fused3d.evp_tie_reach): there the
    two trial deviators agree at visc_max, and the invariants differ by
    less than the f32 step rounds them (their float64 gap below 1 of that
    error), so either branch is a correct f32 step.  The reach stays
    within 5 % of the elements."""
    cfg = multimat3d_cfg("maxwell", mesh={"ylength": 16e3})
    assert_maxwell3_close(_run3(cfg, 3, True), _run3(cfg, 3, False), get)
    assert_evp3_one_step_close(_run3(cfg, 1, True), _run3(cfg, 1, False),
                               get)
    cfg = multimat3d_cfg(mesh={"ylength": 16e3}, ic={"weakzone_option": 1})
    sim = des.Simulation(des.param_from_dict(cfg), device="cpu")
    elems, nodes, gap = fused3d.evp_tie_reach(
        fused3d.make_plan(sim.param, sim.ctx, "cpu"), sim.ctx, sim.state)
    assert gap < 1 and float(elems.double().mean()) <= 0.05

    def away_from_ties(s, f):
        v = get(s, f)
        return v[~(elems if v.shape[0] == elems.numel() else nodes).numpy()]

    assert_evp3_one_step_close(_run3(cfg, 1, True), _run3(cfg, 1, False),
                               away_from_ties)


def test_fused3d_production_vs_plain(cuda):
    """The boundary-process instances (the Winkler and water facet
    tractions, surface process 1) against the plain version on the CPU: a
    10-step maxwell chunk of one material at the maxwell gate, dhacc and
    edvacc_surf within 5e-3 (test_pallas3d.py:262-276), then one EVP step
    of the production3d feature set (two materials) at the one-step gate
    away from what its ties of equal nonzero invariants reach
    (fused3d.evp_tie_reach, at most 5 % of the elements).  dhacc and
    edvacc_surf are left out of the EVP step, as test_pallas3d.py:287-303
    leaves them out: a tie's branch moves its nodes, and the diffusion
    carries that to the top nodes around them (0.13 of dhacc's max at
    128 x 16 x 8 cells)."""
    cfg = _cfg3(mat={"rheology_type": "maxwell"}, ic={"weakzone_option": 0},
                **BOUNDARY3)
    ref, out = _run3(cfg, 10, True), _run3(cfg, 10, False)
    assert_maxwell3_close(ref, out, get)
    assert float(ref.dhacc.abs().max()) > 0
    for f in ("dhacc", "edvacc_surf"):
        assert rel_err(get(ref, f), get(out, f)) < 5e-3, f
    cfg = multimat3d_cfg(mesh={"ylength": 16e3}, ic={"weakzone_option": 1},
                         **BOUNDARY3)
    sim = des.Simulation(des.param_from_dict(cfg), device="cpu")
    elems, nodes, gap = fused3d.evp_tie_reach(
        fused3d.make_plan(sim.param, sim.ctx, "cpu",
                          sim.compensation_pressure), sim.ctx, sim.state)
    assert gap < 1 and float(elems.double().mean()) <= 0.05

    def away_from_ties(s, f):
        v = get(s, f)
        return v[~(elems if v.shape[0] == elems.numel() else nodes).numpy()]

    assert_evp3_one_step_close(_run3(cfg, 1, True), _run3(cfg, 1, False),
                               away_from_ties)


def test_fused3d_production_chunk_equals_complete_steps(cuda):
    """The boundary-process instances' chunk form against 10 complete
    kernel steps, every plane (dhacc, edv_a, edv_b included) bit for bit,
    and one launch of the surface pass among each step's."""
    cfg = multimat3d_cfg("maxwell", mesh={"ylength": 16e3}, **BOUNDARY3)
    sim = des.Simulation(des.param_from_dict(cfg), device="cuda")
    P = fused3d.make_plan(sim.param, sim.ctx, sim.device,
                          sim.compensation_pressure)
    assert P.facets and P.sw["surf_on"] and not P.uniform
    out = fused3d.run_chunk(P, sim.ctx, sim.state, 10)
    e, nd = fused3d.state_to_planes(out, P.nx, P.ny, P.nz, P.smaps)
    b = fused3d.make_buffers(P, sim.ctx, sim.state, 10)
    for k in range(10):
        b.tgt = fused3d.vbc_targets(sim.ctx, b.nin, b.scal[3] + b.scal[0])
        fused3d.fused3d_step(P, b)
        fused2d.dt_refresh(P, b, k, tiled=True, every=True)
        b.swap()
    torch.cuda.synchronize()
    for i in range(fused3d.NE):
        assert torch.equal(e[i], b.ein[i]), i
    for i, nm in enumerate(fused3d.N_SLOTS + fused3d.SURF_SLOTS):
        assert torch.equal(nd[i], b.nin[i]), nm
    assert float(out.dhacc.abs().max()) > 0


def test_fused3d_refused_launch_raises(cuda):
    """The 3D entry refuses a mixed plan with more materials than the
    kernel holds (MAXMAT), and the wrapper raises without counting a
    launch."""
    sim = des.Simulation(des.param_from_dict(multimat3d_cfg(
        mesh={"ylength": 16e3})), device="cuda")
    P = fused3d.make_plan(sim.param, sim.ctx, sim.device)
    b = fused3d.make_buffers(P, sim.ctx, sim.state, 1)
    ip = P.ip.copy()
    ip[fused3d.IP_FIELDS.index("nmat")] = fused3d.MAXMAT + 1
    before = fused3d.fused3d_step.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        fused3d.fused3d_chunk_step(dataclasses.replace(P, ip=ip), b, 0, 1)
    assert fused3d.fused3d_step.launches == before


def test_fused3d_initial_volume_is_the_kernels(cuda):
    sim = des.Simulation(des.param_from_dict(_cfg3()), device="cuda")
    P = fused3d.make_plan(sim.param, sim.ctx, sim.device)
    b = fused3d.make_buffers(P, sim.ctx, sim.state, 1)
    b.scal[0] = 0.0
    fused3d.fused3d_step(P, b)
    torch.cuda.synchronize()
    vol = fused3d._eslot("volume")
    assert torch.equal(b.eout[vol], b.ein[vol])


def test_fused3d_chunk_equals_complete_steps(cuda):
    """The kernel's chunk form (run_chunk: the epilogue of each step
    pending until the next, one finalize) against 10 complete kernel steps
    (fused3d_step, then dt_refresh and a swap): every plane equal, bit for
    bit (the test of tests/test_torch_fused3d.py on the card)."""
    sim = des.Simulation(des.param_from_dict(
        _cfg3(mat={"rheology_type": "maxwell"}, ic={"weakzone_option": 0})),
        device="cuda")
    P = fused3d.make_plan(sim.param, sim.ctx, sim.device)
    before = fused3d.fused3d_finalize.launches
    out = fused3d.run_chunk(P, sim.ctx, sim.state, 10)
    assert fused3d.fused3d_finalize.launches == before + 1
    e, nd = fused3d.state_to_planes(out, P.nx, P.ny, P.nz)
    b = fused3d.make_buffers(P, sim.ctx, sim.state, 10)
    for k in range(10):
        b.tgt = fused3d.vbc_targets(sim.ctx, b.nin, b.scal[3] + b.scal[0])
        fused3d.fused3d_step(P, b)
        fused2d.dt_refresh(P, b, k, tiled=True, every=True)
        b.swap()
    torch.cuda.synchronize()
    for i in range(fused3d.NE):
        assert torch.equal(e[i], b.ein[i]), i
    for i in range(fused3d.NN):
        assert torch.equal(nd[i], b.nin[i]), fused3d.N_SLOTS[i]


def test_fused3d_chunk_stores_last_only_planes_once(cuda):
    """The kernel leaves the planes of last_only_slots unwritten on a
    chunk's inner steps and writes every other one."""
    sim = des.Simulation(des.param_from_dict(_cfg3()), device="cuda")
    P = fused3d.make_plan(sim.param, sim.ctx, sim.device)
    b = fused3d.make_buffers(P, sim.ctx, sim.state, 2)
    b.eout.fill_(float("nan"))
    b.nout.fill_(float("nan"))
    b.tgt = fused3d.vbc_targets(sim.ctx, b.nin, b.scal[3] + b.scal[0])
    fused3d.fused3d_chunk_step(P, b, 0, 2)
    torch.cuda.synchronize()
    skip_e, skip_n = fused3d.last_only_slots(P)
    for i in range(fused3d.NE):
        assert bool(b.eout[i].isnan().all()) == (i in skip_e), i
    for i in range(fused3d.NN):
        assert bool(b.nout[i].isnan().all()) == (i in skip_n), i


@pytest.mark.parametrize("refresh", [0.0, 1.0], ids=["off_cadence",
                                                     "refresh"])
def test_dt_refresh_every_step_mode(cuda, refresh):
    """The 3D mode of the dt_refresh kernel against its plain version on
    the partials of one fused 3D step."""
    sim = des.Simulation(des.param_from_dict(_cfg3()), device="cuda")
    P = fused3d.make_plan(sim.param, sim.ctx, sim.device)
    kb = fused3d.make_buffers(P, sim.ctx, sim.state, 1)
    fused3d.fused3d_step(P, kb)
    kb.flags[0, 0] = refresh
    scal, part = kb.scal.clone(), kb.part.clone()
    dthist, flags = kb.dthist.clone(), kb.flags.clone()
    fused2d.dt_refresh(P, kb, 0, tiled=True, every=True)
    fused2d.dt_refresh_plain(P, part, scal, dthist, flags, 0, tiled=True,
                             every=True)
    torch.cuda.synchronize()
    # the L2 partial is a sum in another order; the rest is exact
    assert torch.equal(kb.scal[[0, 1, 2, 3, 5]], scal[[0, 1, 2, 3, 5]])
    assert abs(float(kb.scal[4] - scal[4])) <= 1e-5 * float(scal[4])


def _band_mesh(kind):
    """The Delaunay box renumbered along x ("tri"), the same with its nodes
    numbered at random ("tri_shuffled": the kernels must not rest on
    locality; every gather tile unstaged), the same with its first and
    last two node ids swapped ("mixed": staged and unstaged tiles in one
    launch), a 32 km square box ("wide": staged windows of more than 768
    rows, over 48 KB of shared memory at f64 and k = 8), the 5-tet grid
    ("tet", npe = 4)."""
    if kind == "tet":
        m = regular_grid_3d(16e3, 8e3, 4e3, 1e3)
        return m.connectivity, m.nnode
    m = unstructured_box_2d(*((32e3, 32e3) if kind == "wide"
                              else (16e3, 8e3)), 250.0)
    coord, conn, _ = renumber_mesh(m.coord, m.connectivity)
    n = coord.shape[0]
    if kind == "tri_shuffled":
        perm = np.random.default_rng(7).permutation(n)
        conn = perm[conn].astype(np.int32)
    if kind == "mixed":
        perm = np.arange(n)
        perm[[0, 1, n - 2, n - 1]] = [n - 1, n - 2, 1, 0]
        conn = perm[conn].astype(np.int32)
    return conn, n


def _tile_premise(kind, bt):
    """The gather tiles each mesh is there for."""
    staged = int(bt.tile_staged.sum())
    ntiles = bt.tile_staged.numel()
    if kind == "tri_shuffled":
        assert staged == 0
    elif kind == "mixed":
        assert 0 < staged < ntiles
    else:
        assert staged == ntiles
    if kind == "wide":
        assert bt.win_rows * band2d.KMAX * 8 > 48 * 1024


def _fan(n):
    """n triangles around node 0: a node of degree n."""
    i = np.arange(1, n + 1)
    return np.stack([np.zeros(n, int), i, i + 1], 1).astype(np.int32), n + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("kind", ["tri", "tri_shuffled", "mixed", "wide",
                                  "tet"])
def test_band_kernels_equal_plain(cuda, kind, dtype):
    """cgather, asm_pack and asm_gather at every k from 1 to KMAX and kg in
    {1, k} (the flat step's six call sites among them): torch.equal with
    the plain versions, launches counted."""
    conn, nnode = _band_mesh(kind)
    bt = band2d.build_tables(conn, nnode, cuda)
    _tile_premise(kind, bt)
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=cuda)

    before = (band2d.cgather.launches, band2d.asm_pack.launches,
              band2d.asm_gather.launches)
    n_gather = 0
    for k in range(1, band2d.KMAX + 1):
        pack = rnd(nnode, k)
        assert torch.equal(band2d.cgather(pack, bt),
                           band2d.gather_corners(pack, bt)), k
        cols = rnd(k, bt.npe, bt.nelem)
        assert torch.equal(band2d.asm_pack(cols, bt),
                           band2d.scatter_corners(cols, bt)), k
        for kg in sorted({1, k}):
            got = band2d.asm_gather(cols, bt, kg)
            want = band2d.scatter_gather_corners(cols, bt, kg)
            assert torch.equal(got[0], want[0]), (k, kg)
            assert torch.equal(got[1], want[1]), (k, kg)
            n_gather += 1
    torch.cuda.synchronize()
    assert (band2d.cgather.launches, band2d.asm_pack.launches,
            band2d.asm_gather.launches) == (before[0] + band2d.KMAX,
                                            before[1] + band2d.KMAX,
                                            before[2] + n_gather)


def test_band_high_degree_node(cuda):
    """Rows far longer than the kernel's UNROLL (a node of degree 1000, the
    slots past UNROLL added one by one), f32 and f64: equal to the plain
    versions."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    conn, nnode = _fan(1000)
    bt = band2d.build_tables(conn, nnode, cuda)
    for dtype in (torch.float32, torch.float64):
        for k in (1, 2, 5, 8):
            cols = torch.randn((k, 3, bt.nelem), generator=gen, dtype=dtype,
                               device=cuda)
            want = band2d.scatter_corners(cols, bt)
            assert torch.equal(band2d.asm_pack(cols, bt), want), k
            sums, gath = band2d.asm_gather(cols, bt, k)
            assert torch.equal(sums, want), k
            assert torch.equal(gath, band2d.gather_corners(want, bt)), k


def test_band_wrappers_raise_on_the_card(cuda):
    """On a CUDA tensor a wrapper launches or raises; it never takes the
    plain version."""
    conn, nnode = _band_mesh("tri")
    bt = band2d.build_tables(conn, nnode, cuda)
    calls = band2d.gather_corners.calls
    scalls = band2d.scatter_corners.calls
    with pytest.raises(ValueError):
        band2d.cgather(torch.zeros((nnode, 4), device=cuda)[:, ::2], bt)
    with pytest.raises(TypeError):
        band2d.cgather(torch.zeros((nnode, 2), device=cuda,
                                   dtype=torch.float16), bt)
    with pytest.raises(TypeError, match="conn_cm"):
        band2d.cgather(torch.zeros((nnode, 2), device=cuda),
                       band2d.build_tables(conn, nnode, "cpu"))
    # a window wider than the kernel stages: the C side refuses the launch
    wide = dataclasses.replace(bt, win_rows=band2d.W_MAX + 1)
    launches = (band2d.cgather.launches, band2d.asm_gather.launches)
    with pytest.raises(RuntimeError, match="gather_corners launch failed"):
        band2d.cgather(torch.zeros((nnode, 2), device=cuda), wide)
    with pytest.raises(RuntimeError, match="scatter_gather_corners launch"):
        band2d.asm_gather(torch.zeros((2, bt.npe, bt.nelem), device=cuda),
                          wide, 1)
    assert (band2d.cgather.launches, band2d.asm_gather.launches) == launches
    assert band2d.gather_corners.calls == calls
    assert band2d.scatter_corners.calls == scalls


@pytest.mark.parametrize("rheology,n,dtype,tol", [
    ("maxwell", 10, "float32", 1e-5),
    ("elasto-visco-plastic", 1, "float32", 1e-5),
    ("maxwell", 10, "float64", 1e-10)])
def test_flat_slice_card_vs_cpu(cuda, rheology, n, dtype, tol):
    """The unstructured slice on the card against the port on the CPU
    (f32: tests/test_flat.py:469-476's tolerance, 1e-5 of each field's max;
    f64, the double instantiations of the kernels: 1e-10), two launches of
    each kernel per step and no plain version."""
    par = des.param_from_dict(flat_cfg(rheology, dtype,
                                       mesh={"resolution": 500.0}))
    on_card = des.Simulation(par)
    before = (band2d.cgather.launches, band2d.asm_pack.launches,
              band2d.asm_gather.launches, band2d.gather_corners.calls,
              band2d.scatter_corners.calls)
    out = on_card.run_steps(n, chunk=n)
    torch.cuda.synchronize()
    assert on_card.step_path == "flat2d" and on_card.device.type == "cuda"
    assert (band2d.cgather.launches, band2d.asm_pack.launches,
            band2d.asm_gather.launches, band2d.gather_corners.calls,
            band2d.scatter_corners.calls) == (
        before[0] + 2 * n, before[1] + 2 * n, before[2] + 2 * n,
        before[3], before[4])
    ref = des.Simulation(par, device="cpu").run_steps(n, chunk=n)
    for f in FLAT_FIELDS:
        err = rel_err(get(ref, f), get(out, f))
        assert err < tol, (f, err)


@pytest.mark.parametrize("hydraulic", [False, True],
                         ids=["maxwell", "hydraulic"])
def test_flat3d_card_vs_cpu(cuda, hydraulic):
    """The 3D column step (flat3d, npe = 4) on the card: one step with the
    kernels equal on every field to one with the plain versions on the
    card, then 10 float64 maxwell steps against the port on the CPU at
    1e-10 of each field's max, with the launches the step makes (the
    packed gather in two calls, 8 + 2 fields, under hydraulic diffusion)
    and no plain version."""
    over = ({"control": {"has_hydraulic_diffusion": True},
             "mat": {"porosity": [0.1], "hydraulic_perm": [1e-15],
                     "fluid_bulk_modulus": [2.2e9], "biot_coeff": [0.8]}}
            if hydraulic else {})
    par = des.param_from_dict(flat3d_cfg(**over))
    on_card = des.Simulation(par)
    one = on_card._chunk_fn(1)(on_card.ctx, on_card.state)
    plain = flat3d.make_chunk_runner(par, on_card.ctx,
                                     on_card.compensation_pressure, 1,
                                     plain=True)(on_card.ctx, on_card.state)
    for f in FIELD_NAMES:
        assert torch.equal(getattr(one, f), getattr(plain, f)), f
    n = 10
    before = (band2d.cgather.launches, band2d.asm_pack.launches,
              band2d.asm_gather.launches, band2d.gather_corners.calls,
              band2d.scatter_corners.calls)
    out = on_card.run_steps(n, chunk=n)
    torch.cuda.synchronize()
    assert on_card.step_path == "flat3d"
    assert (band2d.cgather.launches, band2d.asm_pack.launches,
            band2d.asm_gather.launches, band2d.gather_corners.calls,
            band2d.scatter_corners.calls) == (
        before[0] + (2 + hydraulic) * n, before[1] + 2 * n,
        before[2] + 2 * n, before[3], before[4])
    ref = des.Simulation(par, device="cpu").run_steps(n, chunk=n)
    for f in FLAT_FIELDS + ("ppressure",):
        err = rel_err(get(ref, f), get(out, f))
        assert err < 1e-10, (f, err)


def test_golden_maxwell_2d_on_the_card(cuda, tmp_path, monkeypatch):
    """The maxwell-2d golden through the CLI on the card (flat2d, float64:
    the double instances of the band kernels, 2 launches of each per
    step), every frame at the golden thresholds of
    tests/test_torch_golden.py, read with the port's compare.py."""
    import os

    from dynearthsol_tpu_torch.__main__ import main as cli_main
    from dynearthsol_tpu_torch.compare import _frame_quantities, reldiff
    from dynearthsol_tpu_torch.postproc import OutputReader

    rundir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden", "runs", "maxwell-2d")
    cfg = open(os.path.join(rundir, "case.cfg")).read().replace(
        "modelname = ref", "modelname = our")
    cfg += (f"\n[mesh]\nmesh_from_run = {os.path.join(rundir, 'ref')}\n"
            "mesh_from_run_frame = 0\n[markers]\n"
            "reference_compatible_rng = yes\n")
    (tmp_path / "case.cfg").write_text(cfg)
    monkeypatch.chdir(tmp_path)
    before = (band2d.cgather.launches, band2d.asm_pack.launches,
              band2d.asm_gather.launches)
    assert cli_main(["case.cfg"]) == 0
    after = (band2d.cgather.launches, band2d.asm_pack.launches,
             band2d.asm_gather.launches)
    assert [a - b for a, b in zip(after, before)] == [2000, 2000, 2000]
    loose = {"X velocity", "Z velocity", "S. rate I", "S. rate II",
             "Stress I", "Stress II", "Viscosity"}
    ref, our = OutputReader(os.path.join(rundir, "ref")), OutputReader("our")
    assert our.frames == ref.frames and our.steps == ref.steps
    for frame in ref.frames:
        old = _frame_quantities(ref, frame, include_markers=False)
        new = _frame_quantities(our, frame, include_markers=False)
        for kind in old:
            err = sum(reldiff(old[kind], new[kind]))
            assert err <= (1e-7 if kind in loose else 1e-8), \
                (frame, kind, err)


def test_halo_step_card_vs_cpu(cuda):
    """The node-sharded halo step (parallel/halo_step.py) on 2 shards of
    cuda:0 against the same 2-shard run on the CPU (chip_smoke.py phase
    18 at test size): 10 float64 maxwell steps with the facet tractions
    and surface process 1 on tests/test_halo.py's raster, 1e-10 of each
    field's max, the band kernels launched on every shard's window and no
    plain version; the overlap rows of the two shards equal bit for
    bit."""
    from dynearthsol_tpu_torch.parallel import ShardGroup
    from dynearthsol_tpu_torch.parallel import halo_step as H
    from torch_cases import HALO_FACETS, HALO_FIELDS, halo_cfg

    par = des.param_from_dict(halo_cfg("maxwell", **HALO_FACETS))
    n = 10
    out = {}
    for where in ("cuda:0", "cpu"):
        sim = des.Simulation(par, device=where)
        group = ShardGroup([where] * 2)
        ctx_sh, st, run_chunk, plan = H.make_halo_runner(sim, group)
        before = (band2d.cgather.launches, band2d.asm_pack.launches,
                  band2d.gather_corners.calls, band2d.scatter_corners.calls)
        st = run_chunk(ctx_sh, st, n)
        torch.cuda.synchronize()
        after = (band2d.cgather.launches, band2d.asm_pack.launches,
                 band2d.gather_corners.calls, band2d.scatter_corners.calls)
        if where != "cpu":
            assert after[0] > before[0] and after[1] > before[1]
            assert after[2:] == before[2:]
            h2 = 2 * plan.h
            assert torch.equal(st[0].vel[plan.width - h2:], st[1].vel[:h2])
        out[where] = H.unpack_state(st, plan, sim.state, device="cpu")
    for f in HALO_FIELDS + ("dhacc", "edvacc_surf"):
        err = rel_err(get(out["cpu"], f), get(out["cuda:0"], f))
        assert err < 1e-10, (f, err)
