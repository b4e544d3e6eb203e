"""fuzzypatternmatching_tpu_torch — the fuzzy pattern matcher on PyTorch and CUDA.

A port of ``fuzzypatternmatching_tpu`` (JAX, the reference) to torch tensors
with hand-written CUDA kernels for NVIDIA Hopper. Modules mirror the JAX
package's paths. The host-side numpy modules (graph, pattern, io,
generators, the host NLCC engine, the native library binding) are the
port's own copies of the JAX package's, giving the same arrays.

  - ops/lcc_superstep.py:   the superstep kernels and their plain twins
  - ops/nlcc_frontier.py:   the NLCC walk kernels and their plain twins
  - engine/lcc_bucketed.py: bucketed-ELL LCC engine on a torch device
  - engine/driver.py:       MatchEngine, the prune-to-fixpoint search
  - engine/nlcc.py:         host NLCC/TDS token walks
  - engine/nlcc_device.py:  the same walks on a torch device (DeviceNlcc)
  - cli/run_pattern_matching.py: the search CLI
  - golden.py:              the golden configurations (examples/results_golden)

This package imports torch and never jax, nor anything of the JAX package.
"""
