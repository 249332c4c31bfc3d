"""The CUDA kernels of the PyTorch port (csrc/fused2d.cu, csrc/fused3d.cu,
csrc/band2d.cu) against their plain PyTorch versions, on the card (the
checks of chip_smoke.py phases 3, 4 and 8-9 at the 16 x 128-cell 2D,
128 x 16 x 8-cell 3D and small unstructured sizes), with the CPU tests'
tolerances; the 3D kernel against the plain version run on the CPU (see
_run3); the gather and assembly kernels with tolerance 0.  Imports no JAX.
Skips where there is no CUDA device; on the card run it as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

import dynearthsol_tpu_torch as des
from dynearthsol_tpu_torch.mesh.generate import (regular_grid_3d,
                                                 renumber_mesh,
                                                 unstructured_box_2d)
from dynearthsol_tpu_torch.ops import band2d, fused2d, fused3d
from torch_cases import (FLAT_FIELDS, STEP3_CASES,
                         assert_evp3_one_step_close,
                         assert_evp_one_step_close, assert_maxwell3_close,
                         assert_maxwell_close, assert_resident_matches_tiled,
                         flat_cfg, make_sim3d_cfg, make_sim_cfg, rel_err)

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
    P = fused2d.make_plan(sim.param, sim.ctx, sim.device)
    out = fused2d.run_chunk(P, sim.ctx, sim.state, n, resident, plain)
    torch.cuda.synchronize()
    return out


def test_maxwell_10_steps(cuda):
    cfg = make_sim_cfg(mat={"rheology_type": "maxwell"})
    before = fused2d.fused_step.launches
    out = _run(cfg, 10, False, False)
    assert fused2d.fused_step.launches == before + 10
    assert_maxwell_close(_run(cfg, 10, False, True), out, get)


def test_evp_one_step(cuda):
    cfg = make_sim_cfg()
    assert_evp_one_step_close(_run(cfg, 1, False, True),
                              _run(cfg, 1, False, False), get)


def test_resident_matches_tiled(cuda):
    cfg = make_sim_cfg()
    tiled = _run(cfg, 25, False, False)
    before = fused2d.dt_refresh.launches
    res = _run(cfg, 25, True, False)
    assert fused2d.dt_refresh.launches == before + 25
    assert_resident_matches_tiled(tiled, res, get)


def test_initial_volume_is_the_kernels(cuda):
    sim = des.Simulation(des.param_from_dict(make_sim_cfg()), device="cuda")
    P = fused2d.make_plan(sim.param, sim.ctx, sim.device)
    b = fused2d.make_buffers(P, sim.ctx, sim.state, 1, tiled=False)
    b.scal[0] = 0.0
    fused2d.fused_step(P, b, 0)
    torch.cuda.synchronize()
    vol = fused2d._eslot("volume")
    assert torch.equal(b.eout[vol], b.ein[vol])


def _run3(cfg, n, plain):
    """n fused 3D steps: the kernel on the card, or the plain version on the
    CPU.  PyTorch on the card divides by a Python number as a product with
    its reciprocal, an ulp off true division for a third of the values,
    which flips exact ties of the EVP min-select; on the CPU it divides
    truly, as the kernel does."""
    sim = des.Simulation(des.param_from_dict(cfg),
                         device="cpu" if plain else "cuda")
    P = fused3d.make_plan(sim.param, sim.ctx, sim.device)
    out = fused3d.run_chunk(P, sim.ctx, sim.state, n, plain)
    torch.cuda.synchronize()
    return out


def _cfg3(**over):
    return make_sim3d_cfg(mesh={"ylength": 16e3}, **over)


def test_fused3d_maxwell_10_steps(cuda):
    cfg = _cfg3(mat={"rheology_type": "maxwell"}, ic={"weakzone_option": 0})
    before = (fused3d.fused3d_step.launches, fused2d.dt_refresh.launches)
    out = _run3(cfg, 10, False)
    assert (fused3d.fused3d_step.launches,
            fused2d.dt_refresh.launches) == (before[0] + 10, before[1] + 10)
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


def test_fused3d_initial_volume_is_the_kernels(cuda):
    sim = des.Simulation(des.param_from_dict(_cfg3()), device="cuda")
    P = fused3d.make_plan(sim.param, sim.ctx, sim.device)
    b = fused3d.make_buffers(P, sim.ctx, sim.state, 1)
    b.scal[0] = 0.0
    fused3d.fused3d_step(P, b)
    torch.cuda.synchronize()
    vol = fused3d._eslot("volume")
    assert torch.equal(b.eout[vol], b.ein[vol])


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
    if kind == "tet":
        m = regular_grid_3d(16e3, 8e3, 4e3, 1e3)
        return m.connectivity, m.nnode
    m = unstructured_box_2d(16e3, 8e3, 250.0)
    coord, conn = renumber_mesh(m.coord, m.connectivity)
    return conn, coord.shape[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("kind", ["tri", "tet"])
def test_band_kernels_equal_plain(cuda, kind, dtype):
    """cgather, asm_pack and asm_gather at the k / kg of the flat step's six
    call sites: torch.equal with the plain versions, launches counted."""
    conn, nnode = _band_mesh(kind)
    bt = band2d.build_tables(conn, nnode, cuda)
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=cuda)

    before = (band2d.cgather.launches, band2d.asm_pack.launches,
              band2d.asm_gather.launches)
    for k in (6, 2):
        pack = rnd(nnode, k)
        assert torch.equal(band2d.cgather(pack, bt),
                           band2d.gather_corners(pack, bt))
    for k in (2, 5):
        cols = rnd(k, bt.npe, bt.nelem)
        assert torch.equal(band2d.asm_pack(cols, bt),
                           band2d.scatter_corners(cols, bt))
    for k, kg in ((2, 1), (1, 1)):
        cols = rnd(k, bt.npe, bt.nelem)
        got = band2d.asm_gather(cols, bt, kg)
        want = band2d.scatter_gather_corners(cols, bt, kg)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.cuda.synchronize()
    assert (band2d.cgather.launches, band2d.asm_pack.launches,
            band2d.asm_gather.launches) == tuple(b + 2 for b in before)


def test_band_wrappers_raise_on_the_card(cuda):
    """On a CUDA tensor a wrapper launches or raises; it never takes the
    plain version."""
    conn, nnode = _band_mesh("tri")
    bt = band2d.build_tables(conn, nnode, cuda)
    calls = band2d.gather_corners.calls
    with pytest.raises(ValueError):
        band2d.cgather(torch.zeros((nnode, 4), device=cuda)[:, ::2], bt)
    with pytest.raises(TypeError):
        band2d.cgather(torch.zeros((nnode, 2), device=cuda,
                                   dtype=torch.float16), bt)
    with pytest.raises(TypeError, match="conn_cm"):
        band2d.cgather(torch.zeros((nnode, 2), device=cuda),
                       band2d.build_tables(conn, nnode, "cpu"))
    assert band2d.gather_corners.calls == calls


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
