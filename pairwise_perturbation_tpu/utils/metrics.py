"""CSV metrics + wall-clock accounting with the reference's exact schema.

CP runs emit ``[dim],[iter],[gradnorm],[tol],[pp_update],[diffV],[dtime]``
(als_CP.cxx:133-134); Tucker substitutes ``[diffnorm]``
(als_Tucker.cxx:246); bench mode emits ``[timetype],[dtime]`` rows with
``[DTtime]`` / ``[PPfirst]`` / ``[PPsecond]`` (pp_bench.cxx:297-298,
als_CP.cxx:203-208, 735-748). The visdom dashboard
(visdom/visdom_pull_server.py) parses the convergence schema unchanged.

Wall-clock: diagnostics (gradnorm + residual recomputation) are *excluded*
from reported ``dtime`` exactly like the reference's
``st_time += MPI_Wtime() - st_time1`` bookkeeping (als_CP.cxx:480-482).
"""

from __future__ import annotations

import time
from typing import Optional, TextIO


class PlotFile:
    """CSV writer matching the reference Plot_File behavior."""

    CP_HEADER = "[dim],[iter],[gradnorm],[tol],[pp_update],[diffV],[dtime]"
    TUCKER_HEADER = "[dim],[iter],[diffnorm],[tol],[pp_update],[diffV],[dtime]"
    BENCH_HEADER = "[timetype],[dtime]"

    def __init__(self, path: Optional[str], header: str = CP_HEADER,
                 echo: bool = True):
        self.path = path
        self.echo = echo
        self._fh: Optional[TextIO] = open(path, "w") if path else None
        self._rows = 0
        if self._fh is not None:
            self._fh.write(header + "\n")

    def row(self, dim, it, metric, tol, pp_update, diffV, dtime):
        line = f"{dim},{it},{metric},{tol},{pp_update},{diffV},{dtime}"
        if self._fh is not None:
            self._fh.write(line + "\n")
            self._rows += 1
            if self._rows % 100 == 0:
                self._fh.flush()
        if self.echo:
            print(f"  [dim]=  {dim}  [iter]=  {it}  [metric]  {metric}"
                  f"  [tol]  {tol}  [pp_update]  {pp_update}"
                  f"  [diffV]  {diffV}  [dtime]  {dtime}")

    def bench_row(self, timetype: str, dtime: float):
        if self._fh is not None:
            self._fh.write(f"[{timetype}],{dtime}\n")
            self._fh.flush()
        if self.echo:
            print(f"  [{timetype}]  {dtime}")

    def flush(self):
        if self._fh is not None:
            self._fh.flush()

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class SweepClock:
    """Wall clock with excluded-diagnostics accounting (als_CP.cxx:189-190).

    Drivers drain the device queue with ``jax.block_until_ready`` before
    an excluded window opens, so the wait for queued sweeps is charged to
    dtime and only the diagnostics themselves are excluded.
    """

    def __init__(self):
        self.st_time = time.perf_counter()

    def exclude(self):
        """Context manager: time spent inside is excluded from dtime."""
        clock = self

        class _Excl:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *a):
                clock.st_time += time.perf_counter() - self.t0
                return False

        return _Excl()

    def dtime(self) -> float:
        return time.perf_counter() - self.st_time

    def reset(self):
        self.st_time = time.perf_counter()
