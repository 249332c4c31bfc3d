"""The port's post-processing (dynearthsol_tpu_torch/postproc.py) against
the JAX package's on the CPU.

- The derived fields on inputs drawn from a numpy seed, in float64, within
  1e-12 of each result's max: principal stress (2D closed form; in 3D
  batched eigh, whose eigenvectors are defined up to sign, so s1/s3 are
  compared up to sign where the eigenvalues are apart by more than 1e-2 of
  their scale, and by length everywhere, degenerate rows included), heat
  flux and melting.  In 3D the top surface of a 5-tet box repeats x
  values; melting interpolates it on the host with np.argsort and
  np.interp, as the JAX package does, and the port reproduces which of the
  repeated nodes numpy reads (the reference's behaviour, kept, not fixed).
- ``main`` (so ``to_vtk`` and ``to_vtp``) of both packages with -p -m
  --melting --heatflux on copies of the same frame files, written by the
  port's CLI (2D and 3D, markers on; the 3D run remeshes before its last
  frame): the same files, the same stdout lines, the same headers and
  lines of numbers.  Each number is within 1e-12 of its block's max
  |value| (a heat-flux component: of the flux's, the solve rounding the
  gradient as a vector), or prints apart only in its tenth significant
  digit (1e-9 of itself): the text is the JAX package's %.10g, and a
  number whose two derivations round apart by an ulp can print apart
  there (none does on these frames).  In 3D, s1/s3 are held as above,
  at 1e-9: in a run's stresses near-degenerate eigenvalues are common, and
  numpy's and PyTorch's LAPACK calls round their eigenvectors apart.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import dynearthsol_tpu_torch as tdes
from dynearthsol_tpu import postproc as jpp
from dynearthsol_tpu_torch import postproc as tpp
from dynearthsol_tpu_torch.__main__ import run
from dynearthsol_tpu_torch.mesh.generate import create_new_mesh
from dynearthsol_tpu_torch.mesh.topology import build_topology
from torch_cases import flat3d_cfg, flat_cfg, rel_err

TOL = 1e-12
TOL_TEXT = 1e-9


def _inputs(ndims, seed):
    """A box mesh (5-tet cells in 3D) with nodes moved by up to a quarter
    of a cell, its boundary flags, random stresses (some rows with
    repeated eigenvalues), temperatures and materials 0-3."""
    rng = np.random.default_rng(seed)
    p = tdes.param_from_dict({
        "sim": {"ndims": ndims},
        "mesh": {"meshing_option": 1, "meshing_elem_shape": 1,
                 "xlength": 8e3, "ylength": 4e3 if ndims == 3 else 0.0,
                 "zlength": 4e3, "resolution": 1e3}})
    m = create_new_mesh(p)
    topo = build_topology(m, p.mesh.xlength, p.mesh.ylength,
                          p.mesh.zlength)
    coord = m.coord.copy()
    inner = topo.bcflag == 0
    coord[inner] += rng.uniform(-250.0, 250.0, (inner.sum(), ndims))
    nelem = m.connectivity.shape[0]
    nstr = 3 if ndims == 2 else 6
    stress = rng.normal(0.0, 1e7, (nelem, nstr))
    stress[:4, nstr // 2:] = 0.0          # diagonal: ...
    stress[:2, :ndims] = -5e7             # ... isotropic
    stress[2:4, 1:ndims] = 3e7            # ... two equal eigenvalues
    temperature = rng.uniform(273.0, 1700.0, len(coord))
    material = rng.integers(0, 4, nelem).astype(np.float64)
    return coord, m.connectivity, topo.bcflag, stress, temperature, material


def _held_up_to_sign(x, y, stress, s3, tol):
    """3D s1 (or s3) of two derivations: their lengths within ``tol`` of
    the max length everywhere; the vectors up to sign where the eigenvalue
    is apart from its neighbour by more than 1e-2 of the largest |value|
    (a pair nearer than that turns its vectors by more than rounding).
    Returns that mask."""
    i, j = np.triu_indices(3, 1)
    m = np.zeros((len(stress), 3, 3))
    m[:, range(3), range(3)] = stress[:, :3]
    m[:, i, j] = m[:, j, i] = stress[:, [3, 4, 5]]
    w = np.linalg.eigvalsh(m)
    gap = w[:, 2] - w[:, 1] if s3 else w[:, 1] - w[:, 0]
    lx, ly = (np.linalg.norm(v, axis=1) for v in (x, y))
    assert np.abs(lx - ly).max() <= tol * lx.max()
    clear = gap > 1e-2 * np.abs(w).max(1)
    d = np.minimum(np.abs(x - y).max(1), np.abs(x + y).max(1))
    assert d[clear].max(initial=0.0) <= tol * lx.max()
    return clear


@pytest.mark.parametrize("ndims", [2, 3])
def test_derived_fields_against_jax(ndims, monkeypatch):
    coord, conn, bcflag, stress, temp, mat = _inputs(ndims, 11 + ndims)
    ja = jpp.compute_principal_stress(stress)
    ta = [t.numpy() for t in tpp.compute_principal_stress(
        torch.as_tensor(stress))]
    # the 3D eigh in blocks of 100 matrices: the same vectors
    monkeypatch.setattr(tpp, "EIGH_BLOCK", 100)
    for x, y in zip(ta, tpp.compute_principal_stress(stress, "cpu")):
        assert np.array_equal(x, y.numpy())
    if ndims == 2:
        for x, y in zip(ja, ta):
            assert rel_err(x, y) < TOL
    else:
        for x, y, s3 in zip(ja, ta, (False, True)):
            clear = _held_up_to_sign(x, y, stress, s3, TOL)
            assert clear.mean() > 0.95 and not clear[:2].any()
    jf = jpp.compute_heat_flux(coord, conn, temp, 2.9)
    tf = tpp.compute_heat_flux(coord, conn, temp, 2.9, device="cpu")
    for x, y in zip(jf, tf):
        assert rel_err(x, y.numpy()) < TOL
    jm = jpp.compute_melting(coord, conn, temp, mat, bcflag)
    tm = tpp.compute_melting(coord, conn, temp, mat, bcflag, device="cpu")
    assert (jm == -1000.0).any() and (jm > 0).any()
    assert rel_err(jm, tm.numpy()) < TOL


def _blocks(path):
    """[(header tokens, numbers (n, k))] of a text file: each block is the
    lines of numbers after lines with words, whose tokens are its
    header."""
    blocks = [([], [])]
    for line in open(path).read().split("\n"):
        tok = line.split()
        try:
            blocks[-1][1].append([float(t) for t in tok])
        except ValueError:
            if blocks[-1][1]:
                blocks.append(([], []))
            blocks[-1][0].extend(tok)
    return [(h, np.array([v for v in nums if v])) for h, nums in blocks]


def _text_close(path_a, path_b, stress=None):
    """Two text files: the same headers and lines, the numbers of each
    block within TOL of the block's max |value| or within TOL_TEXT of
    themselves (one unit of the tenth digit).  With ``stress`` (3D), the
    s1/s3 blocks are held as the derived-field test holds them.  Returns
    (numbers, numbers whose tenth digit flipped)."""
    ba, bb = _blocks(path_a), _blocks(path_b)
    assert [h for h, _ in ba] == [h for h, _ in bb], path_a
    # a heat-flux component's scale is the flux's (the solve rounds the
    # gradient as a vector)
    flux = [np.abs(x).max() for h, x in ba
            if h[1:2] == ["heat_flux_magnitude"]]
    count = flips = 0
    for (head, x), (_, y) in zip(ba, bb):
        assert x.shape == y.shape, (path_a, head)
        if not x.size:
            continue
        count += x.size
        if stress is not None and head[:2] in (["VECTORS", "s1"],
                                               ["VECTORS", "s3"]):
            _held_up_to_sign(x, y, stress, head[1] == "s3", TOL_TEXT)
            continue
        scale = flux[0] if head[1].startswith("heat_flux_") \
            else np.abs(x).max()
        d = np.abs(x - y)
        digit = d <= TOL_TEXT * np.abs(x)
        assert (d[~digit] <= TOL * scale).all(), (path_a, head)
        flips += int((digit & (d > TOL * scale)).sum())
    return count, flips


@pytest.mark.parametrize("ndims", [2, 3])
def test_main_converts_as_jax(tmp_path, capsys, ndims):
    cfg = flat_cfg() if ndims == 2 else flat3d_cfg("elasto-visco-plastic")
    cfg["sim"].update(max_steps=6, output_step_interval=3,
                      modelname=str(tmp_path / "run" / "pp"))
    cfg["mesh"]["quality_check_step_interval"] = 3
    os.makedirs(tmp_path / "run")
    run(tdes.param_from_dict(cfg), device="cpu")
    capsys.readouterr()
    args = ["-p", "-m", "--melting", "--heatflux", "pp"]
    cwd = os.getcwd()
    out = {}
    try:
        for name, mod, extra in (("jax", jpp, []),
                                 ("our", tpp, ["--device", "cpu"])):
            shutil.copytree(tmp_path / "run", tmp_path / name)
            os.chdir(tmp_path / name)
            assert mod.main(extra + args) == 0
            out[name] = capsys.readouterr().out.splitlines()
    finally:
        os.chdir(cwd)
    assert out["jax"] == out["our"]
    assert out["our"][-1] == "3 frames converted"
    new = {name: sorted(set(os.listdir(tmp_path / name))
                        - set(os.listdir(tmp_path / "run")))
           for name in ("jax", "our")}
    assert new["jax"] == new["our"]
    assert sorted(f for f in new["our"] if f.endswith(".vtp")) == \
        [f"pp.markerset.{k:06d}.vtp" for k in range(3)]
    counts = {}
    for f in new["our"]:
        frame = int(f.split(".")[-2])
        stress = (tpp.OutputReader(str(tmp_path / "run" / "pp")).read_field(
            frame, "stress") if ndims == 3 and f.endswith(".vtk") else None)
        counts[f] = _text_close(tmp_path / "jax" / f, tmp_path / "our" / f,
                                stress)
    print("numbers and tenth-digit flips by file:", counts)
    assert sum(n for n, _ in counts.values()) > 10000
