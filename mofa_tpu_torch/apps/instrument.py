"""CLI observability: per-phase wall clock and an optional device trace.

Counterpart of mofa_tpu/apps/instrument.py. Every inference CLI gains:

  --timings        print a per-phase wall-clock table (device-synchronised)
                   on exit
  --trace_dir DIR  write a torch.profiler Chrome trace of the generation
                   phase (the denoise loop and the decode)

Under a process group only rank 0 prints the table.
"""

from __future__ import annotations

import contextlib

from mofa_tpu_torch.core.mesh import is_main_rank
from mofa_tpu_torch.utils.profiling import PhaseTimer, trace


def add_observability_args(parser):
    parser.add_argument("--timings", action="store_true",
                        help="print per-phase wall-clock timings on exit")
    parser.add_argument("--trace_dir", default=None,
                        help="write a torch.profiler Chrome trace here")
    return parser


@contextlib.contextmanager
def observe(args, device=None):
    """Yields a PhaseTimer on `device`; prints the phase table when
    --timings is set."""
    timer = PhaseTimer(device)
    try:
        yield timer
    finally:
        if getattr(args, "timings", False) and is_main_rank():
            print(timer.report())


def maybe_trace(trace_dir):
    """Profiler trace of the generation phase only, or nothing."""
    return trace(trace_dir) if trace_dir else contextlib.nullcontext()
