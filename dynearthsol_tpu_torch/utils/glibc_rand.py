"""glibc rand() replica for reference-compatible marker streams (a copy
of dynearthsol_tpu/utils/glibc_rand.py, which this package cannot import).

The reference seeds C rand() with markers.random_seed and draws marker
barycentric coordinates from it sequentially (srand at
markerset.cxx:521-524; random_eta at :116-133 draws NDIMS uniforms per
try and retries while their sum >= 1).  Reproducing the BYTE-IDENTICAL
stream lets a repo run place markers exactly where the reference binary
does, which unlocks cross-code golden gates on multi-material
(marker-histogram-mixed) fields — the heart of matprops.cxx:115-144.

glibc's rand() is random() is the TYPE_3 additive-feedback generator
(glibc stdlib/random_r.c): a 34-word state seeded by the Park-Miller
LCG via Schrage's method, the recurrence r[i] = r[i-31] + r[i-3]
(mod 2^32) with the first 310 outputs discarded, each output the sum
shifted right by one.  Implemented here in numpy (vectorized in chunks
of 3 — the shortest feedback lag) and validated word-for-word against
glibc in tests/test_markers.py; tests/test_torch_io.py holds this copy
to the JAX package's.
"""

from __future__ import annotations

import numpy as np

RAND_MAX = 2147483647


def glibc_rand_stream(seed: int, n: int) -> np.ndarray:
    """First ``n`` outputs of glibc rand() after srand(seed), int64."""
    if seed == 0:
        seed = 1  # glibc: seed 0 is replaced by 1
    total = 344 + n  # 34 seed words + 310 discards + n outputs
    r = np.zeros(total, dtype=np.int64)
    r[0] = np.int64(np.int32(seed))
    # Park-Miller via Schrage (random_r.c __srandom_r): signed arithmetic
    for i in range(1, 31):
        hi, lo = divmod(int(r[i - 1]), 127773)
        word = 16807 * lo - 2836 * hi
        if word < 0:
            word += 2147483647
        r[i] = word
    r[31:34] = r[0:3]
    # additive recurrence, vectorized in chunks of the lag-3 feedback
    i = 34
    while i < total:
        j = min(i + 3, total)
        r[i:j] = (r[i - 31:j - 31] + r[i - 3:j - 3]) & 0xFFFFFFFF
        i = j
    return (r[34 + 310:] >> 1).astype(np.int64)


def reference_random_eta(seed: int, nmark: int, ndims: int) -> np.ndarray:
    """Barycentric marker coordinates exactly as MarkerSet::random_eta
    draws them (markerset.cxx:116-133): per marker, NDIMS uniforms
    rand()/RAND_MAX; accept when their sum < 1 (last coordinate is the
    remainder), else redraw.  Returns (nmark, ndims+1) float64."""
    npe = ndims + 1
    # every try consumes exactly NDIMS draws whether accepted or not, so
    # the try sequence is position-independent: fully vectorizable
    factor = 3 if ndims == 2 else 10  # accept prob 1/2 (2D) / 1/6 (3D)
    while True:
        u = (glibc_rand_stream(seed, nmark * ndims * factor)
             .astype(np.float64) / RAND_MAX)
        tries = u.reshape(-1, ndims)
        ssum = tries.sum(axis=1)
        ok = np.flatnonzero(ssum < 1.0)
        if ok.size >= nmark:
            break
        factor *= 2  # extremely unlikely headroom miss
    ok = ok[:nmark]
    out = np.empty((nmark, npe), dtype=np.float64)
    out[:, :ndims] = tries[ok]
    out[:, ndims] = 1.0 - ssum[ok]
    return out
