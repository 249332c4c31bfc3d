"""VTKHDF frames (dynearthsol_tpu_torch/io/vtkhdf.py and the vtkhdf branch
of io/output.py) against the JAX package's, on the CPU with h5py.

- Small float64 runs in 2D and 3D: the JAX package steps 5 times, its
  state and markers are carried into the port (torch_cases.carry) and
  each package writes an averaged frame.  The two files have the same
  tree (every link, soft links with their targets, every attribute) and
  every dataset has the same dtype, compression and values bit for bit,
  but for three: ``walltime_sec`` (each writer's own clock), and
  ``density`` and ``mesh quality``, which each package computes from the
  carried state (Simulation.elem_density / elem_quality, 1e-12 of the
  max; they part by 1.6e-16 and 6.7e-16).
- Both packages' OutputReaders read both files alike.
- Both CLIs (torch_cases.run_both_clis) with output_format = vtkhdf: the
  same frame files, trees and dtypes, the values within 1e-10 of each
  dataset's max (integers equal).
- Without h5py (sys.modules['h5py'] = None) the port's CLI refuses the
  format with an ImportError naming h5py before the set-up: no Simulation,
  no .info, no frame.
"""

import sys

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

import dynearthsol_tpu as jdes
import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu.io.output import Output as JOutput
from dynearthsol_tpu.postproc import OutputReader as JReader
from dynearthsol_tpu_torch.io.output import Output as TOutput
from dynearthsol_tpu_torch.postproc import OutputReader as TReader
from torch_cases import carry, flat3d_cfg, flat_cfg, run_both_clis

CLOCK = "VTKHDF/grid/FieldData/walltime_sec"
COMPUTED = ("density", "mesh quality")


def h5_tree(path):
    """({link name: (link class, soft-link target, attributes)} of every
    link, the root's attributes included, {dataset name: (array,
    compression, options, shuffle)} of every hard-linked dataset)."""
    tree, data = {}, {}
    with h5py.File(path) as f:
        tree["/"] = ("root", None, dict(f.attrs))

        def visit(name):
            link = f.get(name, getlink=True)
            obj = f[name]
            tree[name] = (type(link).__name__, getattr(link, "path", None),
                          dict(obj.attrs))
            if isinstance(link, h5py.HardLink) and \
                    isinstance(obj, h5py.Dataset):
                data[name] = (obj[:], obj.compression,
                              obj.compression_opts, obj.shuffle)
        f.visit_links(visit)
    return tree, data


def _same_attrs(a, b):
    assert list(a) == list(b)
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def assert_same_tree(ta, tb):
    assert list(ta) == list(tb)
    for name in ta:
        assert ta[name][:2] == tb[name][:2], name
        _same_attrs(ta[name][2], tb[name][2])


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """{ndims: (JAX frame, port frame)} of one averaged frame after 5
    float64 steps, 2D (262 triangles) and 3D (886 tets), markers
    included."""
    out = {}
    for ndims, cfg in ((2, flat_cfg()), (3, flat3d_cfg())):
        d = tmp_path_factory.mktemp(f"vtkhdf{ndims}d")
        cfg["sim"].update(output_format="vtkhdf",
                          is_outputting_averaged_fields=True)
        cfg["mesh"]["quality_check_step_interval"] = 5
        paths = []
        for pkg, out_cls in ((jdes, JOutput), (tdes, TOutput)):
            cfg["sim"]["modelname"] = str(d / pkg.__name__)
            kw = {} if pkg is jdes else {"device": "cpu"}
            sim = pkg.Simulation(pkg.param_from_dict(cfg), **kw)
            if pkg is jdes:
                sim.run_steps(5, chunk=5)
                js = sim
            else:
                carry(js, sim)
            paths.append(out_cls(sim.param).write(sim))
        out[ndims] = tuple(paths)
    return out


@pytest.mark.parametrize("ndims", [2, 3])
def test_frame_equals_the_jax_writer(frames, ndims):
    (ta, da), (tb, db) = (h5_tree(p) for p in frames[ndims])
    assert_same_tree(ta, tb)
    assert "VTKHDF/grid/PointData/velocity" in ta
    assert ta["VTKHDF/grid/CellData/stress"][:2] == ("SoftLink", "/stress")
    assert any(n.startswith("markerset.") for n in da)
    assert list(da) == list(db)
    for name in da:
        (x, *ca), (y, *cb) = da[name], db[name]
        assert ca == cb and x.dtype == y.dtype and x.shape == y.shape, name
        if name == CLOCK:
            continue
        if name in COMPUTED:
            assert np.abs(x - y).max() <= 1e-12 * np.abs(x).max(), name
        else:
            assert np.array_equal(x, y), name


@pytest.mark.parametrize("ndims", [2, 3])
def test_readers_read_both_files_alike(frames, ndims):
    readers = []
    for path in frames[ndims]:
        model = path[:-len(".save.000000.vtkhdf")]
        readers += [JReader(model), TReader(model)]
    for r in readers:
        assert (r.format, r.ndims, r.frames) == ("hdf5", ndims, [0])
    ref = readers[0]
    names = ("coordinate", "connectivity", "velocity", "stress",
             "velocity averaged", "stress averaged", "bcflag", "material")
    for r in readers[1:]:
        for name in names:
            assert r.has_field(0, name) == ref.has_field(0, name) is True
            x, y = ref.read_field(0, name), r.read_field(0, name)
            assert x.dtype == y.dtype and np.array_equal(x, y), name
        assert not r.has_field(0, "no such field")
        ma, mb = ref.read_markers(0), r.read_markers(0)
        assert list(ma) == list(mb) and ma["size"] == mb["size"] > 0
        for k in ma:
            assert np.array_equal(ma[k], mb[k]), k


def test_clis_write_the_same_vtkhdf_frames(tmp_path):
    cfg = flat_cfg()
    cfg["sim"].update(output_format="vtkhdf", max_steps=10,
                      output_step_interval=5,
                      is_outputting_averaged_fields=True)
    cfg["mesh"]["quality_check_step_interval"] = 5
    run_both_clis(tmp_path, cfg)
    for name in ("jax", "our"):
        assert sorted(p.name for p in (tmp_path / name).glob("*.vtkhdf")) \
            == [f"{name}.save.{k:06d}.vtkhdf" for k in range(3)]
    for k in range(3):
        (ta, da), (tb, db) = (h5_tree(tmp_path / n / f"{n}.save.{k:06d}"
                                      ".vtkhdf") for n in ("jax", "our"))
        assert_same_tree(ta, tb)
        assert list(da) == list(db)
        for name in da:
            x, y = da[name][0], db[name][0]
            assert x.dtype == y.dtype and x.shape == y.shape, name
            if name == CLOCK:
                continue
            if x.dtype.kind != "f":
                assert np.array_equal(x, y), (k, name)
                continue
            err = np.abs(x - y).max() / max(np.abs(x).max(), 1e-300)
            assert err <= 1e-10, (k, name, err)


def test_refused_without_h5py(tmp_path, monkeypatch):
    from dynearthsol_tpu_torch import __main__ as cli

    def no_setup(*a, **k):
        raise AssertionError("the run was set up before the refusal")

    monkeypatch.setitem(sys.modules, "h5py", None)
    monkeypatch.setattr(cli, "Simulation", no_setup)
    cfg = flat_cfg()
    cfg["sim"].update(output_format="vtkhdf", max_steps=2,
                      modelname=str(tmp_path / "noh5"))
    with pytest.raises(ImportError, match="h5py"):
        cli.run(tdes.param_from_dict(cfg), device="cpu")
    assert list(tmp_path.iterdir()) == []
