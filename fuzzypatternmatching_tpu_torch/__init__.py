"""fuzzypatternmatching_tpu_torch — the fuzzy pattern matcher on PyTorch and CUDA.

A port of ``fuzzypatternmatching_tpu`` (JAX, the reference) to torch tensors
with hand-written CUDA kernels for NVIDIA Hopper. Modules mirror the JAX
package's paths; the modules that import no JAX (graph, pattern, io,
generators, the host NLCC engine, the native library) are shared, not
copied.

  - ops/lcc_superstep.py:   the two superstep kernels and their plain twins
  - engine/lcc_bucketed.py: bucketed-ELL LCC engine on a torch device
  - engine/driver.py:       MatchEngine, the prune-to-fixpoint search
  - cli/run_pattern_matching.py: the search CLI

This package imports torch and never jax.
"""
