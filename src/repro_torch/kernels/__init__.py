"""Hand-written CUDA kernels of the port (Hopper, sm_90a).

Each kernel module holds the ctypes launcher of one ``csrc/*.cu`` source
and the plain PyTorch version beside it; ``ops.py`` holds the public
wrappers and their launch counters; ``solver_backends.py`` registers the
kernels as the engine's ``"hopper"`` backend (imported lazily).

  multi_count.py         K2  one-round multi-threshold count
  runahead_threshold.py  K3  fused multi-round top-k solve
  multi_mass.py          K4  one-round multi-threshold mass (top-p)
  multi_entropy.py       K5  one-round multi-temperature entropy moments
  taylor_eval.py         K1  the paper's Taylor-series f at M points
  paged_attend.py        K6  paged decode attention over a page table
  flash_fwd.py           K7  causal flash-attention forward (training,
                             long prefill), with its autograd rule
  row_reduce.py              K4 and K5's shared grid, scratch, launch and
                             stage clock (csrc/row_reduce.cuh)
  blocks.py                  the JAX kernels' fit math, Hopper's
                             shared-memory fit, chunk geometry
"""
