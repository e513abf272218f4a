"""Golden NumPy re-derivations of the reference algorithms.

These are small, deliberately literal (streaming-order) implementations used
only in tests, pinning the semantics the device kernels must reproduce. The
reference itself ships no tests (SURVEY.md §4); this package substitutes for
that missing oracle.
"""
