"""One torch thread in every process that runs the port's CPU tests.

Importing this module sets torch's intra-op pool to one thread for the
whole process.  Every port test module imports it, and every
pytest-xdist worker imports every test module while it collects, so in
the tier-1 run each worker runs on one torch thread from its first
test.  By default each of the run's workers takes a thread per core of
the host it shares with the others, and the small ops of the port's
reduced models then spend their time waiting on one another.  Measured
with the tier-1 command in one sandbox of 8 cores: 1181 s at the
default, 1007-1061 s with one thread inside the port's modules only,
752-837 s with one thread for the whole process, JAX's files included
(``tools/tier1_replay.py`` reads the runs' junit reports).  The ranks
``launch/mesh.py::spawn_local`` starts run on one thread already.
"""
import torch

torch.set_num_threads(1)
