"""Git metadata for run records (``repro.core.folder.git_metadata``): the
commit, branch and commit timestamp that ``PerfSession.finalize`` stamps
on a persisted record."""

from __future__ import annotations

import subprocess


def git_metadata(cwd: str = ".") -> dict:
    """Collect git metadata (commit, branch, commit timestamp) if available."""

    def _git(*args: str) -> str | None:
        try:
            out = subprocess.run(
                ["git", *args], cwd=cwd, capture_output=True, text=True, timeout=10
            )
            return out.stdout.strip() if out.returncode == 0 else None
        except (OSError, subprocess.TimeoutExpired):
            return None

    meta = {}
    if commit := _git("rev-parse", "HEAD"):
        meta["git_commit"] = commit
        meta["git_commit_short"] = commit[:8]
    if branch := _git("rev-parse", "--abbrev-ref", "HEAD"):
        meta["git_branch"] = branch
    if ts := _git("show", "-s", "--format=%cI", "HEAD"):
        meta["git_commit_timestamp"] = ts
    return meta
