"""Multi-stage analysis campaigns with artifact gating and resume (a copy
of ``nekstab_next_tpu/campaign.py``; host-only Python, no numpy or torch).

A :class:`Campaign` is an ordered list of :class:`Stage` objects, each with

* ``done(workdir) -> bool``: artifact check (skip completed stages on
  resume);
* ``gate(workdir) -> None``: raise if prerequisites are unhealthy (a
  residual gate);
* ``run(workdir) -> dict``: do the work, write artifacts, return a summary
  merged into the campaign report.

State lives on disk (JSON report + each stage's own files), so an
interrupted campaign resumes where it stopped.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import traceback
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class Stage:
    name: str
    run: Callable[[str], dict]
    done: Optional[Callable[[str], bool]] = None
    gate: Optional[Callable[[str], None]] = None


class GateError(RuntimeError):
    """A prerequisite artifact exists but fails its quality gate."""


def residual_gate(path: str, tol: float) -> Callable[[str], None]:
    """Gate on the last value of a residual time-series file being < tol
    (the reference's ``check_last_value``, check_next.py:66-70)."""

    def gate(workdir: str) -> None:
        p = os.path.join(workdir, path)
        if not os.path.exists(p):
            raise GateError(f"missing residual file {p}")
        with open(p) as fh:
            lines = [ln for ln in fh.read().splitlines() if ln.strip()]
        last = float(lines[-1].split()[-1])
        if not last < tol:
            raise GateError(f"{p}: last residual {last} >= tol {tol}")

    return gate


def artifact_exists(*paths: str) -> Callable[[str], bool]:
    def done(workdir: str) -> bool:
        return all(os.path.exists(os.path.join(workdir, p)) for p in paths)

    return done


class Campaign:
    """Run stages in order, skipping completed ones, persisting a report.

    ``report.json`` in the workdir records per-stage status/timing/summary;
    rerunning the campaign after an interruption re-checks ``done`` and
    continues from the first unfinished stage."""

    def __init__(self, workdir: str, stages: List[Stage]):
        self.workdir = workdir
        self.stages = stages
        os.makedirs(workdir, exist_ok=True)
        self._report_path = os.path.join(workdir, "report.json")
        self.report: Dict[str, dict] = {}
        if os.path.exists(self._report_path):
            with open(self._report_path) as fh:
                self.report = json.load(fh)

    def _save(self) -> None:
        with open(self._report_path, "w") as fh:
            json.dump(self.report, fh, indent=1, default=str)

    def run(self, stop_on_error: bool = True) -> Dict[str, dict]:
        for st in self.stages:
            entry = self.report.get(st.name, {})
            if entry.get("status") == "done" and (
                st.done is None or st.done(self.workdir)
            ):
                continue
            if st.done is not None and st.done(self.workdir):
                self.report[st.name] = {"status": "done", "skipped": True}
                self._save()
                continue
            if st.gate is not None:
                try:
                    st.gate(self.workdir)
                except GateError as e:
                    self.report[st.name] = {"status": "gated", "error": str(e)}
                    self._save()
                    if stop_on_error:
                        raise
                    break
            t0 = time.time()
            try:
                summary = st.run(self.workdir) or {}
            except Exception as e:  # noqa: BLE001 - recorded + re-raised
                self.report[st.name] = {
                    "status": "failed",
                    "error": f"{e!r}",
                    "traceback": traceback.format_exc(),
                    "wall_s": time.time() - t0,
                }
                self._save()
                if stop_on_error:
                    raise
                break
            self.report[st.name] = {
                "status": "done",
                "wall_s": time.time() - t0,
                **summary,
            }
            self._save()
        return self.report
