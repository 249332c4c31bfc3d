"""The port's file formats and restart (io/tagged.py, io/output.py,
io/restart.py, postproc.py, compare.py, markers.py, utils/glibc_rand.py,
mesh/topology.build_topology_from_arrays, remeshing.bad_mesh_quality)
against the JAX package's, on the CPU.

Files: the port writes the bytes the JAX package writes.  From one state
(the JAX Simulation's, carried to the port with state_from_numpy and
stepped there, then carried back) both packages' Output write a frame and
a checkpoint: the same array names, dtypes and lengths, every array
byte-identical but the two derived element fields, density and mesh
quality, which are computed by each package and held at 1e-12 relative in
float64.  Restart: the JAX package's contract (tests/test_io.py:95-130), a
run restarted from a checkpoint equals the continuous run bit for bit,
every State field, here on flat2d in float64 and on the resident 2D
runner in float32 (the plain versions on the CPU).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu import compare as jcompare
from dynearthsol_tpu import postproc as jpost
from dynearthsol_tpu import remeshing as jremesh
from dynearthsol_tpu.io import Output as JOutput
from dynearthsol_tpu.io import tagged as jtagged
from dynearthsol_tpu.state import State as JState
from dynearthsol_tpu.utils import glibc_rand as jrand
from dynearthsol_tpu_torch import compare as tcompare
from dynearthsol_tpu_torch import postproc as tpost
from dynearthsol_tpu_torch import remeshing as tremesh
from dynearthsol_tpu_torch.__main__ import main as cli_main
from dynearthsol_tpu_torch.io import Output, restart, tagged
from dynearthsol_tpu_torch.state import (FIELD_NAMES, state_from_numpy,
                                         state_to_numpy)
from dynearthsol_tpu_torch.utils import glibc_rand as trand
from torch_cases import flagship_cfg, flat_cfg

RUNS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                    "runs")
DERIVED = ("density", "mesh quality")


def _cfg(tmp_path, name, base, **sim):
    cfg = base
    cfg["sim"].update(modelname=str(tmp_path / name), **sim)
    return cfg


def _arrays(path):
    """{name: raw bytes} of a tagged file, each array's extent from the
    offsets."""
    with jtagged.TaggedReader(path) as r:
        pos = sorted(r.offset.items(), key=lambda kv: kv[1])
        r.f.seek(0, 2)
        ends = [p for _, p in pos[1:]] + [r.f.tell()]
        out = {}
        for (name, p), e in zip(pos, ends):
            r.f.seek(p)
            out[name] = r.f.read(e - p)
        return r.ndims, out


# ---------------------------------------------------------------- tagged

def test_tagged_round_trip_both_ways(tmp_path):
    a = np.arange(12, dtype=np.float64).reshape(4, 3) * 0.1
    b = np.arange(5, dtype=np.int32)
    for w_mod, r_mod, tag in ((tagged, jtagged, "port"),
                              (jtagged, tagged, "jax")):
        path = str(tmp_path / f"{tag}.bin")
        with w_mod.TaggedWriter(path, 2) as w:
            w.write_array(a, "alpha")
            w.write_array(b, "beta idx")
        with r_mod.TaggedReader(path) as r:
            assert r.ndims == 2 and r.revision == 3
            assert np.array_equal(
                r.read_array("alpha", np.float64, 12).reshape(4, 3), a)
            assert np.array_equal(r.read_array("beta idx", np.int32, 5), b)
    with open(tmp_path / "port.bin", "rb") as f, \
            open(tmp_path / "jax.bin", "rb") as g:
        assert f.read() == g.read()


# ------------------------------------------ one state, written by both

@pytest.fixture(scope="module")
def both_written(tmp_path_factory):
    """A flat2d float64 run with markers: the JAX initial state, 3 steps
    in the port, then the frame and checkpoint written by each package
    into its own directory.  Returns (jax_sim, port_sim, dirs)."""
    tmp = tmp_path_factory.mktemp("both")
    cfg = flat_cfg("elasto-visco-plastic", markers={
        "markers_per_element": 4, "random_seed": 3})
    js = jdes.Simulation(jdes.param_from_dict(cfg))
    ts = tdes.Simulation(tdes.param_from_dict(cfg), device="cpu")
    s0 = state_from_numpy({f: np.asarray(getattr(js.state, f))
                           for f in FIELD_NAMES}, dtype=ts.dtype)
    ts.state = ts._chunk_fn(3)(ts.ctx, s0)
    js.state = JState(**{f: jnp.asarray(v)
                         for f, v in state_to_numpy(ts.state).items()})
    for nm in ("info_display_next_step", "compensation_pressure",
               "bottom_temperature", "reference_frame_time"):
        assert float(getattr(ts, nm)) == float(getattr(js, nm)), nm
    dirs = {}
    for tag, sim, out_cls in (("jax", js, JOutput), ("port", ts, Output)):
        d = tmp / tag
        d.mkdir()
        sim.param.sim.modelname = str(d / "io")
        out = out_cls(sim.param)
        out.write_checkpoint(sim)
        out.write_exact(sim)
        dirs[tag] = str(d / "io")
    return js, ts, dirs


@pytest.mark.parametrize("kind", ["save", "chkpt"])
def test_frame_and_checkpoint_match_jax_writer(both_written, kind):
    js, ts, dirs = both_written
    nd_j, ja = _arrays(f"{dirs['jax']}.{kind}.000000")
    nd_t, ta = _arrays(f"{dirs['port']}.{kind}.000000")
    assert nd_j == nd_t == 2
    assert list(ja) == list(ta)           # names, in file order
    assert "markerset.eta" in ta or kind == "chkpt"
    for name in ja:
        assert len(ja[name]) == len(ta[name]), name
        if name in DERIVED:
            a = np.frombuffer(ja[name], np.float64)
            b = np.frombuffer(ta[name], np.float64)
            assert np.abs(a - b).max() <= 1e-12 * np.abs(a).max(), name
        else:
            assert ja[name] == ta[name], name


def test_readers_and_compare_match_jax(both_written):
    """The port's OutputReader reads what the JAX one reads, from either
    package's files; compare.reldiff and compare_runs agree."""
    _, ts, dirs = both_written
    fields = ("coordinate", "connectivity", "velocity", "temperature",
              "plastic strain", "strain-rate", "strain", "stress",
              "viscosity", "density", "mesh quality", "material", "force",
              "coord0", "bcflag")
    for model in dirs.values():
        jr, tr = jpost.OutputReader(model), tpost.OutputReader(model)
        assert (tr.frames, tr.steps, tr.time, tr.ndims) == \
            (jr.frames, jr.steps, jr.time, jr.ndims)
        for f in fields:
            a, b = jr.read_field(0, f), tr.read_field(0, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        jm, tm = jr.read_markers(0), tr.read_markers(0)
        assert jm.keys() == tm.keys() and tm["size"] == ts.markers.n
        for k in jm:
            assert np.array_equal(jm[k], tm[k]), k
        jq = jcompare._frame_quantities(jr, 0)
        tq = tcompare._frame_quantities(tr, 0)
        assert jq.keys() == tq.keys()
        for k in jq:
            assert np.array_equal(jq[k], tq[k]), k
            rnd = jq[k] * (1 + 1e-9 * np.arange(jq[k].size) / jq[k].size)
            assert jcompare.reldiff(jq[k], rnd) == \
                tcompare.reldiff(jq[k], rnd)
    for mod in (jcompare, tcompare):
        assert mod.compare_runs(dirs["jax"], dirs["port"], 0,
                                verbose=False) == (0, 0)
        assert mod.main([dirs["jax"], dirs["port"], "0"]) == 0


def test_bad_mesh_quality_matches_jax(both_written):
    js, ts, _ = both_written
    for opt in (0, 13):
        js.param.mesh.remeshing_option = ts.param.mesh.remeshing_option = opt
        assert tremesh.bad_mesh_quality(ts) == jremesh.bad_mesh_quality(js)
    js.param.mesh.min_quality = ts.param.mesh.min_quality = 0.99
    code, q = tremesh.bad_mesh_quality(ts)
    assert code == 1 and (code, q) == jremesh.bad_mesh_quality(js)
    np.testing.assert_allclose(
        ts.elem_quality(), np.asarray(js.elem_quality()), rtol=1e-12)


# ----------------------------------------------------------- restart

def _restart_case(tmp_path, base, n, plain_path):
    """Run 2n steps with a checkpoint at step n, restart from it and run n
    more; returns (continuous, restarted) States."""
    cfg = _cfg(tmp_path, "cont", base, output_step_interval=n,
               checkpoint_frame_interval=1)
    p1 = tdes.param_from_dict(cfg)
    sim = tdes.Simulation(p1, device="cpu")
    out = Output(p1)
    out.write_checkpoint(sim)
    out.write_exact(sim)
    sim.run_steps(n, chunk=n)
    assert sim.step_path == plain_path
    out.write_checkpoint(sim)
    out.write(sim)
    mid = sim.state.coord.clone()
    sim.run_steps(n, chunk=n)
    cfg["sim"].update(is_restarting=True, restarting_from_frame=1,
                      restarting_from_modelname=cfg["sim"]["modelname"])
    sim2, frame = restart(tdes.param_from_dict(cfg), device="cpu")
    assert frame == 1 and int(sim2.state.steps) == n
    assert torch.equal(sim2.state.coord, mid)
    sim2.run_steps(n, chunk=n)
    assert sim2.step_path == plain_path
    return sim.state, sim2.state


@pytest.mark.parametrize("case", ["flat2d_f64", "resident_f32"])
def test_fresh_restart_bitexact(tmp_path, case):
    if case == "flat2d_f64":
        cont, rest = _restart_case(
            tmp_path, flat_cfg("maxwell", markers={
                "markers_per_element": 2}), 10, "flat2d")
    else:
        # the flagship's physics (EVP, the weak zone) in 8 x 256 cells:
        # by step 105, between two dt refreshes (every 10), elements that
        # yielded have gone back to the viscoelastic branch, which keeps
        # their delta_plstrain (read back from the frame)
        cont, rest = _restart_case(
            tmp_path, flagship_cfg(nx_cells=8, nz_cells=256), 105,
            "pallas2d_res")
        assert (rest.delta_plstrain != 0).any()
    for f in FIELD_NAMES:
        assert torch.equal(getattr(cont, f), getattr(rest, f)), f


def _cfg_text(d: dict) -> str:
    def val(v):
        if isinstance(v, bool):
            return "yes" if v else "no"
        if isinstance(v, (list, tuple)):
            return "[ " + ", ".join(map(str, v)) + " ]"
        return str(v)
    return "".join(f"[{sec}]\n" + "".join(f"{k} = {val(v)}\n"
                                           for k, v in kv.items())
                   for sec, kv in d.items())


def test_cli_restart_writes_the_continuous_frames(tmp_path, monkeypatch,
                                                  capsys):
    """Through the CLI: a run restarted from frame 1 into a new model name
    writes frame 2 (save and checkpoint) byte for byte as the continuous
    run, but for the run-time column of .info and two driver scalars of
    the checkpoint, info_display_next_step and reference_frame_time: the
    driver writes a checkpoint before it updates them, as the JAX
    package's does, so a restarted run carries their values of the frame
    before."""
    monkeypatch.chdir(tmp_path)
    cfg = flat_cfg("elasto-visco-plastic")
    cfg["sim"].update(modelname="cont", max_steps=20,
                      output_step_interval=10, checkpoint_frame_interval=1)
    cfg["mesh"]["quality_check_step_interval"] = 5
    (tmp_path / "cont.cfg").write_text(_cfg_text(cfg))
    assert cli_main(["--device", "cpu", "cont.cfg"]) == 0
    cfg["sim"].update(modelname="rest", is_restarting=True,
                      restarting_from_modelname="cont",
                      restarting_from_frame=1)
    (tmp_path / "rest.cfg").write_text(_cfg_text(cfg))
    assert cli_main(["--device", "cpu", "rest.cfg"]) == 0
    printed = capsys.readouterr().out
    assert "Restarted from frame 1 (step 10)." in printed
    assert "Quality:  " in printed and "/ 2 checks" in printed
    for kind in ("save", "chkpt"):
        a, b = _arrays(f"cont.{kind}.000002"), _arrays(f"rest.{kind}.000002")
        assert a[0] == b[0] and a[1].keys() == b[1].keys()
        for name in a[1]:
            if name.startswith("time info_display_next_step"):
                sa, sb = (np.frombuffer(x[1][name], np.float64)
                          for x in (a, b))
                keep = [0, 2, 3, 4, 5]
                assert np.array_equal(sa[keep], sb[keep])
            else:
                assert a[1][name] == b[1][name], (kind, name)
    info = [np.loadtxt(f"{m}.info", ndmin=2) for m in ("cont", "rest")]
    assert info[1][:, 0].tolist() == [2.0]
    np.testing.assert_array_equal(np.delete(info[0][2], 4),
                                  np.delete(info[1][0], 4))


@pytest.mark.parametrize("over,what", [
    ({"monitor": {"enabled": True, "num_points": 1, "points_x": [0.0],
                  "points_z": [0.0]}}, "monitor"),
    ({"ic": {"isostasy_adjustment_time_in_yr": 1.0}}, "isostasy"),
    ({"control": {"use_global_velocity_scaling": True}}, "earthquake"),
    ({"control": {"surface_process_option": 101}}, "custom surface hook"),
])
def test_cli_refuses_unported_driver_features(tmp_path, over, what):
    from dynearthsol_tpu_torch.__main__ import run

    cfg = _cfg(tmp_path, "refused", flat_cfg(), max_steps=2)
    for sec, kv in over.items():
        cfg.setdefault(sec, {}).update(kv)
    with pytest.raises(NotImplementedError, match=what):
        run(tdes.param_from_dict(cfg), device="cpu")
    assert not os.path.exists(cfg["sim"]["modelname"] + ".info")


# ------------------------------------------- markers, rng and meshes

def test_glibc_rand_and_reference_eta_match_jax():
    for seed in (0, 1, 12345, 2**31 - 1):
        assert np.array_equal(trand.glibc_rand_stream(seed, 1000),
                              jrand.glibc_rand_stream(seed, 1000))
    for ndims in (2, 3):
        assert np.array_equal(trand.reference_random_eta(12345, 777, ndims),
                              jrand.reference_random_eta(12345, 777, ndims))


@pytest.mark.parametrize("case", ["maxwell-2d", "maxwell-2mat-3d"])
def test_mesh_from_run_matches_jax(tmp_path, case):
    """load_config takes ndims from the save file; the topology built from
    the reference's arrays is the JAX package's, and so is the marker
    population drawn from the glibc stream."""
    from dynearthsol_tpu.io.restart import load_mesh_from_run as jload
    from dynearthsol_tpu.markers import create_markers as jcreate
    from dynearthsol_tpu_torch.io.restart import load_mesh_from_run
    from dynearthsol_tpu_torch.markers import create_markers

    ref = os.path.join(RUNS, case, "ref")
    text = open(os.path.join(RUNS, case, "case.cfg")).read()
    text += (f"\n[mesh]\nmesh_from_run = {ref}\nmesh_from_run_frame = 0\n"
             "[markers]\nreference_compatible_rng = yes\n"
             "markers_per_element = 2\n")
    (tmp_path / "case.cfg").write_text(text)
    tp = tdes.load_config(str(tmp_path / "case.cfg"))
    jp = jdes.load_config(str(tmp_path / "case.cfg"))
    assert tp.sim.ndims == jp.sim.ndims == (3 if "3d" in case else 2)
    (jm, jt), (tm, tt) = jload(ref, 0), load_mesh_from_run(ref, 0)
    assert np.array_equal(jm.coord, tm.coord)
    assert tt.nseg == jt.nseg
    for f in ("connectivity", "bcflag", "segment", "segflag", "asm_perm",
              "asm_node_ids", "gather_idx", "gather_mask"):
        a, b = getattr(jt, f), getattr(tt, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for a, b in zip(jt.bnodes + jt.bfacets, tt.bnodes + tt.bfacets):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    jmk = jcreate(jp, jm.coord, jt.connectivity)
    tmk = create_markers(tp, tm.coord, tt.connectivity)
    assert tmk.cap == jmk.cap and tmk.n == jmk.n
    for nm in ("eta", "elem", "mattype", "id", "time", "z", "distance",
               "slope", "genesis"):
        assert np.array_equal(tmk.live(nm), jmk.live(nm)), nm
    assert np.array_equal(tmk.elem_histogram(tt.nelem, 2),
                          jmk.elem_histogram(jt.nelem, 2))
