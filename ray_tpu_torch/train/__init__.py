"""Training runtime of the port (counterpart of ray_tpu/train): so far the
mesh placement helpers and the mesh-reshape restore (``train.mesh``)."""
