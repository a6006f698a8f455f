"""A frozen copy of `pim_tpu_torch`'s plain path (see the package note of
`pimbench.reference`).  Do not edit it to follow the port: it is the
yardstick the port is held to."""

import torch

# The CPU build's first vector-math call, on one element (as the port's
# package import does), so that CPU runs of the copy give the same values
# in every process.
torch.sqrt(torch.ones(1))
