"""The port's plain 3D eigensolver (ops/eig3.py) and 3D constitutive cores
(ops/rheology.py *3_c) against the JAX package's, on seeded samples.

Eigenvalues: 1e-12 of the largest magnitude in f64; in f32 eight ulp of
the largest eigenvalue (measured 4.7: torch.cos and jnp.cos differ by an ulp
on about 5% of f32 arguments, and 2p cos(phi) carries that to the
eigenvalues).  Eigenvectors are compared where they are unique (the random
sample).  Cores: 1e-12 in f64 relative to each output's max; in f32 1e-6 as
tests/test_torch_rheology.py, and 4e-6 for the return map, whose principal
stresses carry the cos difference (measured 1.3e-6).  The sample is drawn
so that the return map meets all three of its outcomes (no failure, shear,
tension), and both packages pick the same outcome for every sample.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynearthsol_tpu.ops import eig3 as JE
from dynearthsol_tpu.ops import rheology as JR
from dynearthsol_tpu_torch.ops import eig3 as TE
from dynearthsol_tpu_torch.ops import rheology as TR
from torch_cases import rel_err

N = 4096
DTYPES = {"f64": (np.float64, torch.float64),
          "f32": (np.float32, torch.float32)}


def _matrices(np_dtype):
    """Six-component symmetric matrices: seeded random ones, then exactly
    isotropic ones and ones with two equal eigenvalues."""
    r = np.random.default_rng(7)
    a = r.normal(0, 1e8, (N, 6))
    iso = np.zeros((64, 6))
    iso[:, :3] = r.normal(0, 1e8, (64, 1))
    # Q diag(l0, l1, l1) Q^T with random rotations Q
    q, _ = np.linalg.qr(r.normal(size=(64, 3, 3)))
    lam = r.normal(0, 1e8, (64, 3))
    lam[:, 2] = lam[:, 1]
    m = np.einsum("nij,nj,nkj->nik", q, lam, q)
    two = np.stack([m[:, 0, 0], m[:, 1, 1], m[:, 2, 2], m[:, 0, 1],
                    m[:, 0, 2], m[:, 1, 2]], axis=1)
    return np.concatenate([a, iso, two]).astype(np_dtype)


def _report(rows, m, ref, got, most=8):
    """The failing rows' index, input matrix and both packages' values, at
    full precision (repr of Python floats round-trips)."""
    lines = [f"{rows.size} rows off, the first {min(most, rows.size)}:"]
    for i in rows[:most]:
        lines.append(f"row {i}: m = {[float(x) for x in m[i]]!r}; "
                     f"jax = {[float(x) for x in ref[i]]!r}; "
                     f"torch = {[float(x) for x in got[i]]!r}")
    return "\n".join(lines)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_eigvals3_matches_jax(dt):
    np_dtype, t_dtype = DTYPES[dt]
    m = _matrices(np_dtype)
    ref = JE.eigvals3_c(*(jnp.asarray(m[:, i]) for i in range(6)))
    out = TE.eigvals3_c(*(torch.as_tensor(m[:, i]) for i in range(6)))
    ref = np.stack([np.asarray(x, np.float64) for x in ref], axis=1)
    got = np.stack([x.double().numpy() for x in out], axis=1)
    assert out[0].dtype == t_dtype
    scale = np.abs(ref).max(axis=1)
    tol = 1e-12 if dt == "f64" else 8 * np.finfo(np.float32).eps
    bad = np.flatnonzero(np.abs(ref - got).max(axis=1) > tol * scale)
    assert bad.size == 0, _report(bad, m, ref, got)
    # ascending up to the rounding of l1 = 3q - l0 - l2
    assert (np.diff(got, axis=1) >= -tol * scale[:, None]).all()


def test_eigvals3_one_value_for_any_layout():
    """At a double root r = det(B) / 2 is +-1 to a few ulps, and one ulp of
    r moves an eigenvalue by up to 5e-9 of the scale (acos(1 - e) is
    sqrt(2 e)): test_eigvals3_matches_jax[f64] holds at 1e-12 only while
    both packages compute r bit for bit.  The port's values do not depend
    on the layout of its inputs, where an element falls in a vectorised
    loop or its scalar tail, or the number of threads."""
    m = _matrices(np.float64)

    def eig(a):
        return np.stack([x.numpy() for x in TE.eigvals3_c(
            *(torch.as_tensor(a[:, i]) for i in range(6)))], axis=1)

    ref = eig(m)
    old = torch.get_num_threads()
    try:
        for threads in (1, old):
            torch.set_num_threads(threads)
            for off in (0, 1, 3, 4097):
                sub = np.ascontiguousarray(m[off:])
                assert np.array_equal(eig(sub), ref[off:])
            two = np.ascontiguousarray(m[N + 64:])
            one = np.concatenate([eig(two[i:i + 1]) for i in range(64)])
            assert np.array_equal(one, ref[N + 64:])
    finally:
        torch.set_num_threads(old)


def test_eigvals3_same_bits_in_any_number_of_threads():
    """The eigenvalues of three copies of the sample (12,672 rows, more
    than one intra-op chunk of torch.cos and torch.sqrt would hold) under
    four intra-op threads and under one, bit for bit: the eigensolver's
    cos and sqrt run in the calling thread (ops/eig3.py ``_serial``),
    where a worker thread once gave values 1.4e-11 of the scale off."""
    m = np.tile(_matrices(np.float64), (3, 1))
    cols = [torch.as_tensor(m[:, i]) for i in range(6)]
    old = torch.get_num_threads()
    out = []
    try:
        for threads in (4, 1):
            torch.set_num_threads(threads)
            out.append(np.stack([x.numpy() for x in TE.eigvals3_c(*cols)],
                                axis=1))
    finally:
        torch.set_num_threads(old)
    assert np.array_equal(out[0], out[1])
    assert np.array_equal(out[1][:N + 128], out[1][N + 128:2 * (N + 128)])


@pytest.mark.parametrize("dt", list(DTYPES))
def test_eigh3_matches_jax(dt):
    """Eigenvalues as above; the eigenbasis is orthonormal everywhere, and
    on the random sample it reproduces the matrix and equals the JAX
    package's."""
    np_dtype, t_dtype = DTYPES[dt]
    m = _matrices(np_dtype)
    (jl, jv) = JE.eigh3_c(*(jnp.asarray(m[:, i]) for i in range(6)))
    (tl, tv) = TE.eigh3_c(*(torch.as_tensor(m[:, i]) for i in range(6)))
    eps = 1e-12 if dt == "f64" else 8 * np.finfo(np.float32).eps
    vtol = 1e-12 if dt == "f64" else 1e-5
    lam = np.stack([x.double().numpy() for x in tl], axis=1)
    jlam = np.stack([np.asarray(x, np.float64) for x in jl], axis=1)
    scale = np.abs(jlam).max(axis=1)
    assert tl[0].dtype == tv[0][0].dtype == t_dtype
    assert (np.abs(lam - jlam).max(axis=1) <= eps * scale).all()
    # V[n, k, :] = eigenvector k
    V = np.stack([np.stack([c.double().numpy() for c in v], axis=1)
                  for v in tv], axis=1)
    JV = np.stack([np.stack([np.asarray(c, np.float64) for c in v], axis=1)
                   for v in jv], axis=1)
    eye = np.einsum("nki,nli->nkl", V, V)
    assert np.abs(eye - np.eye(3)).max() <= vtol
    rnd = slice(0, N)
    assert np.abs(V[rnd] - JV[rnd]).max() <= vtol
    # the cross-product eigenvectors carry ~1e-9 (f64) and ~1e-4 (f32) of
    # the matrix's scale in both packages (measured 2e-9 and 2.3e-4)
    rtol = 1e-7 if dt == "f64" else 1e-3
    A = np.einsum("nk,nki,nkj->nij", lam[rnd], V[rnd], V[rnd])
    full = np.stack([m[rnd][:, [0, 3, 4]], m[rnd][:, [3, 1, 5]],
                     m[rnd][:, [4, 5, 2]]], axis=1).astype(np.float64)
    assert (np.abs(A - full).max(axis=(1, 2)) <= rtol * scale[rnd]).all()


def _core_inputs(np_dtype):
    r = np.random.default_rng(4321)

    def u(lo, hi):
        return r.uniform(lo, hi, N).astype(np_dtype)

    return {
        "bulkm": u(30e9, 80e9), "shearm": u(20e9, 50e9),
        "visc": 10.0 ** u(19, 24), "dt": np_dtype(3e10), "dv": u(-1e-5, 1e-5),
        "de": [r.normal(0, 1e-4, N).astype(np_dtype) for _ in range(6)],
        "s": [r.normal(-5e7, 1e8, N).astype(np_dtype) for _ in range(6)],
        "amc": u(1e6, 3e8), "anphi": u(1.5, 4.0), "anpsi": u(1.0, 1.5),
        "hardn": u(-1e7, 0.0), "ten_max": u(1e6, 1e8),
    }


def _run_core(name, mod, arr, x):
    k, g = arr(x["bulkm"]), arr(x["shearm"])
    de, s = tuple(map(arr, x["de"])), tuple(map(arr, x["s"]))
    if name == "elastic3":
        return mod.elastic3_c(k, g, de, s), None
    if name == "maxwell3":
        return mod.maxwell3_c(k, g, arr(x["visc"]), x["dt"], arr(x["dv"]),
                              de, s), None
    if name == "viscous3":
        return mod.viscous3_c(k, arr(x["visc"]), arr(x["dv"]), de), None
    out, depls, mode = mod.elasto_plastic3_c(
        k, g, arr(x["amc"]), arr(x["anphi"]), arr(x["anpsi"]),
        arr(x["hardn"]), arr(x["ten_max"]), de, s)
    return (*out, depls), mode


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", ["elastic3", "maxwell3", "viscous3",
                                  "elasto_plastic3"])
def test_core3_matches_jax(name, dt):
    np_dtype, t_dtype = DTYPES[dt]
    tol = 1e-12 if dt == "f64" else (
        4e-6 if name == "elasto_plastic3" else 1e-6)
    x = _core_inputs(np_dtype)
    ref, jmode = _run_core(name, JR, jnp.asarray, x)
    out, tmode = _run_core(name, TR, torch.as_tensor, x)
    for a, b in zip(ref, out):
        assert b.dtype == t_dtype
        assert rel_err(a, b.numpy()) <= tol
    if name == "elasto_plastic3":
        jmode, tmode = np.asarray(jmode), tmode.numpy()
        # no failure, tension (1) and shear (10) all occur
        assert {0, 1, 10} <= set(np.unique(jmode).tolist())
        assert (jmode == tmode).all()
