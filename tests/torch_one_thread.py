"""Importing this module runs PyTorch's CPU ops on one intra-op thread in
this process.

The port's CPU tests drive tiny models (widths of 64 to 256), whose ops are
far below the size at which PyTorch's OpenMP threads pay for themselves.
The suite runs in several pytest-xdist worker processes on the same cores,
and there each process's intra-op threads spin against the others', which
made the port's tests several times slower.  Every worker imports every test
module while it collects, so the setting holds before the first test of any
file runs, and in a single-process run likewise."""
import torch

torch.set_num_threads(1)
