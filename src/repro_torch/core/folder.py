"""CI folder-structure handling (paper listing 2 + §CI Workflow): the
port's copy of ``repro.core.folder``, on the port's ``RunRecord``, so a
folder may hold the records of either package.

Folder convention: a top-level folder contains experiment folders; any
folder that directly contains ``*.json`` run records is one experiment
(weak/strong scaling or resource comparison). Runs of the same experiment
accumulate in the same folder across CI pipelines (history arrives by
merging the previous pipeline's artifact, see ``merge_history``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

from repro_torch.core.records import RunRecord


@dataclasses.dataclass
class Experiment:
    """One experiment folder: its relative path and loaded runs."""

    rel_path: str
    runs: list[RunRecord]

    @property
    def name(self) -> str:
        return self.rel_path.replace(os.sep, " / ")


def scan(root: str) -> list[Experiment]:
    """Find every experiment under ``root`` (depth-first, stable order)."""
    experiments: list[Experiment] = []
    root = os.fspath(root)
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        jsons = sorted(f for f in filenames if f.endswith(".json"))
        if not jsons:
            continue
        runs = []
        for f in jsons:
            path = os.path.join(dirpath, f)
            try:
                runs.append(RunRecord.load(path))
            except (json.JSONDecodeError, ValueError, KeyError) as e:
                # Tolerate foreign json artifacts in the tree; never die on
                # one bad file in CI (the report must still publish).
                print(f"[talp-pages] skipping unreadable run {path}: {e}")
        if runs:
            experiments.append(
                Experiment(rel_path=os.path.relpath(dirpath, root), runs=runs)
            )
    return experiments


def merge_history(history_root: str, current_root: str) -> int:
    """Copy historic run jsons into the current folder structure (the
    paper's "download previous pipeline artifacts and copy over" step).
    Existing files are never overwritten (current pipeline wins). Returns
    number of files merged."""
    merged = 0
    for dirpath, _, filenames in os.walk(history_root):
        rel = os.path.relpath(dirpath, history_root)
        for f in filenames:
            if not f.endswith(".json"):
                continue
            dst_dir = os.path.join(current_root, rel) if rel != "." else current_root
            dst = os.path.join(dst_dir, f)
            if os.path.exists(dst):
                continue
            os.makedirs(dst_dir, exist_ok=True)
            shutil.copy2(os.path.join(dirpath, f), dst)
            merged += 1
    return merged


def add_metadata(root: str, metadata: dict) -> int:
    """Inject (git) metadata into every run json under ``root`` that does
    not have it yet — the paper's ``talp metadata -i talp`` wrapper."""
    updated = 0
    for dirpath, _, filenames in os.walk(root):
        for f in filenames:
            if not f.endswith(".json"):
                continue
            path = os.path.join(dirpath, f)
            try:
                run = RunRecord.load(path)
            except (json.JSONDecodeError, ValueError, KeyError):
                continue
            changed = False
            for k, v in metadata.items():
                if k not in run.metadata:
                    run.metadata[k] = v
                    changed = True
            if changed:
                run.save(path)
                updated += 1
    return updated


def git_metadata(cwd: str = ".") -> dict:
    """Collect git metadata (commit, branch, commit timestamp) if available."""
    import subprocess

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
