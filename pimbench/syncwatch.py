"""Host syncs counted by source line (a frozen copy of the port's
`bench.py::_sync_watch`, with its `_repo_site`).

torch's sync debug mode ("warn") warns at each host sync on the card; the
watch counts each at the innermost line of the checkout on the stack."""

from __future__ import annotations

import contextlib
import os
import traceback
import warnings

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def repo_site(filename: str, lineno: int, stack=None) -> str:
    """The innermost line of the checkout on the stack of a warning being
    shown (skipping the hook's own frames), else the warning's own
    location."""
    frames = traceback.extract_stack()[:-2] if stack is None else stack
    for f in reversed(frames):
        if f.filename.startswith(ROOT + os.sep):
            return f"{os.path.relpath(f.filename, ROOT)}:{f.lineno}"
    return f"{filename}:{lineno}"


def note_sync(syncs: dict, site: str) -> None:
    syncs["count"] += 1
    syncs["at"][site] = syncs["at"].get(site, 0) + 1


@contextlib.contextmanager
def sync_watch(device: torch.device, syncs: dict):
    """Fills `syncs` ({"count": n, "at": {"file:line": n}}) while the block
    runs with the host syncs torch reports on the card.  The switch into
    the mode happens before the block, unwatched: its first use in a
    process reports a sync of its own."""
    if device.type != "cuda":
        yield
        return

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return shown(message, category, filename, lineno, file, line)
        note_sync(syncs, repo_site(filename, lineno))

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            shown, warnings.showwarning = warnings.showwarning, note
            yield
    finally:
        torch.cuda.set_sync_debug_mode("default")
