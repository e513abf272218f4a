"""hammlet_tpu — a JAX framework for wavelet-compressed Forward-Backward
Gibbs sampling of Bayesian Hidden Markov Models, run on NVIDIA GPUs.

Re-implements the full capability surface of HaMMLET (Wiedenhoeft et al., 2016;
reference C++ implementation) as an idiomatic JAX/XLA framework:

- Haar maxlet transform + breakpoint weights as batch level-wise kernels
  (bit-exact vs the reference's streaming transform, src/wavelet.hpp:98-188).
- Dynamic block compression as fixed-capacity masked boundary extraction with
  O(1) block sufficient-statistic queries via cell-structured prefix sums
  (replaces src/Blocks/BreakpointArray.hpp + src/Statistics/IntegralArray.hpp).
- Forward-Backward Gibbs as two associative scans (matrix-product forward,
  random-map-composition backward) — fully parallel over blocks, shardable
  over a device mesh (replaces src/StateSequence/ForwardBackward.hpp).
- Conjugate Normal-Inverse-Gamma / Dirichlet updates as fused segment
  reductions (replaces src/Conjugate.hpp, src/Theta.hpp, src/Transitions.hpp).
- Run-length-compressed posterior state marginals and the full Records output
  surface (replaces src/StateMarginals.hpp, src/Records.hpp).
- A CLI front end compatible with the reference flag grammar
  (doc/hammlet-manpage.md).
"""

__version__ = "0.1.0"

from hammlet_tpu.models.hmm import HMMState, HMMPriors, ModelSpec  # noqa: F401
