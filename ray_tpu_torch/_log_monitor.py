"""Session directory, worker log redirection and tailing, export events (a
copy of ``ray_tpu/_private/log_monitor.py``).

A node's workers write their stdout and stderr to
``<session>/logs/worker-<id>.out|.err``.  A ``LogMonitor`` thread on the
node tails the directory and hands each fresh line to its ``emit``: the
node sends them up to the head, which prints them with JAX's prefix
(``(worker-xxxxxxxx.err) ...``) on its stderr, and the files stay for
``tail``.  Export events are JSON lines in ``<session>/logs/events.jsonl``.
The session directory's base is ``Config`` ``session_dir``, else
``<tmp>/ray_tpu_torch`` (``tempfile.gettempdir()``).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ._config import Config

#: Seconds between two looks at the log directory.
POLL_S = 0.2


def create_session_dir() -> str:
    base = Config.get("session_dir") or os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch")
    path = os.path.join(
        base, f"session_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}")
    os.makedirs(os.path.join(path, "logs"), exist_ok=True)
    # Convenience symlink like the reference's session_latest.
    link = os.path.join(base, "session_latest")
    try:
        if os.path.islink(link) or os.path.exists(link):
            os.remove(link)
        os.symlink(path, link)
    except OSError:
        pass
    return path


def sweep_dead_sessions(base: str) -> int:
    """Remove the session directories (``session_<time>_<pid>``) under
    ``base`` whose process is gone (a SIGKILLed head leaves its own);
    returns how many went."""
    import shutil
    n = 0
    try:
        names = os.listdir(base)
    except OSError:
        return 0
    for name in names:
        pid_s = name.rsplit("_", 1)[-1]
        if not name.startswith("session_") or not pid_s.isdigit() or \
                int(pid_s) == os.getpid():
            continue
        try:
            os.kill(int(pid_s), 0)
            continue                    # alive (or not ours to judge)
        except ProcessLookupError:
            pass
        except OSError:
            continue
        shutil.rmtree(os.path.join(base, name), ignore_errors=True)
        n += 1
    return n


class LogMonitor:
    """Tails every log file in a directory, emitting new lines (by
    default to this process's stderr with the file's prefix)."""

    def __init__(self, logs_dir: str,
                 emit: Optional[Callable[[str, str], None]] = None):
        self.logs_dir = logs_dir
        self._emit = emit or self._default_emit
        self._offsets: Dict[str, int] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def _default_emit(fname: str, line: str) -> None:
        tag = fname.rsplit(".", 1)[0]
        stream = sys.stderr if fname.endswith(".err") else sys.stdout
        print(f"({tag}) {line}", file=stream)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop,
                                        name="log-monitor", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        # Join so a caller's post-stop flush poll cannot race an in-flight
        # poll (duplicate emission / concurrent offset writes); the loop
        # waits on a 200ms event, so this returns promptly.
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)

    def _loop(self) -> None:
        while not self._stop.wait(POLL_S):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — monitor must never die
                pass

    def poll_once(self) -> int:
        """Scan files once; returns number of lines emitted."""
        emitted = 0
        try:
            names = sorted(os.listdir(self.logs_dir))
        except OSError:
            return 0
        for fname in names:
            if not (fname.endswith(".out") or fname.endswith(".err")):
                continue
            path = os.path.join(self.logs_dir, fname)
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            off = self._offsets.get(fname, 0)
            if size <= off:
                continue
            try:
                with open(path, "rb") as f:
                    f.seek(off)
                    chunk = f.read(size - off)
            except OSError:
                continue
            # Only emit complete lines; keep the partial tail for later.
            last_nl = chunk.rfind(b"\n")
            if last_nl < 0:
                continue
            self._offsets[fname] = off + last_nl + 1
            for raw in chunk[:last_nl].split(b"\n"):
                line = raw.decode("utf-8", "replace").rstrip("\r")
                if line:
                    self._emit(fname, line)
                    emitted += 1
        return emitted

    def tail(self, fname: str, n: int = 100) -> List[str]:
        """Last n lines of one log file (state-API surface)."""
        path = os.path.join(self.logs_dir, os.path.basename(fname))
        try:
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - 256 * 1024))
                data = f.read()
        except OSError:
            return []
        lines = data.decode("utf-8", "replace").splitlines()
        return lines[-n:]

    def list_files(self) -> List[Tuple[str, int]]:
        try:
            return sorted(
                (f, os.path.getsize(os.path.join(self.logs_dir, f)))
                for f in os.listdir(self.logs_dir))
        except OSError:
            return []


class ExportEventWriter:
    """Append-only JSONL of structured lifecycle events."""

    def __init__(self, path: str):
        self._path = path
        self._lock = threading.Lock()
        self._f = open(path, "a", buffering=1)

    def write(self, source_type: str, event: Dict[str, Any]) -> None:
        rec = {"timestamp": time.time(), "source_type": source_type,
               **event}
        try:
            with self._lock:
                self._f.write(json.dumps(rec, default=str) + "\n")
        except ValueError:
            pass  # closed during shutdown race

    def close(self) -> None:
        with self._lock:
            try:
                self._f.close()
            except Exception:  # noqa: BLE001
                pass
