"""Reference-semantics oracle: literal scalar transcriptions.

Every function in this package is a statement-by-statement scalar Python
port of the corresponding Fortran routine in /root/reference — the literal
control flow (IF/DO/EXIT/WHERE), the literal clamps, the literal constants,
in the reference's evaluation order.  They are deliberately slow,
unvectorized, and un-JAX: their only job is to define what the reference
*computes* so the vectorized JAX implementations can be asserted
against them at fp64 rtol <= 1e-12 over randomized full-regime inputs
(tests/test_oracle_ocean.py, tests/test_oracle_ice.py).

A module-level ``HITS`` counter records which control-flow branches /
clamp saturations each run actually exercised, so the tests can assert
that the randomized inputs covered every regime rather than silently
skipping branches.
"""

from collections import Counter

#: branch-coverage counters, bumped by the scalar routines
HITS: Counter = Counter()


def reset_hits():
    HITS.clear()
