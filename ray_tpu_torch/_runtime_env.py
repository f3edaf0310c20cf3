"""Runtime environments beyond env_vars: working_dir, py_modules and pip (a
copy of ``ray_tpu/_private/runtime_env.py``; ``_tasks`` calls it).

Reference analog: python/ray/_private/runtime_env/ (working_dir.py,
py_modules.py, packaging.py) executed by the per-node runtime-env agent
(agent/runtime_env_agent.py:165).  Here the packaging is the same idea —
zip the directory, content-address it by hash — but the transport is the
task spec itself (the blob rides to the node once; extraction is cached
per hash in the node's session dir), and application happens at worker
boot via env vars (the worker chdirs into working_dir and prepends
py_modules to sys.path).

``pip`` environments (reference: runtime_env/pip.py) are venvs created
per requirement-list signature with ``--system-site-packages`` (the base
image's torch/numpy stay visible; pip only layers the extras) — workers of
that env run under the venv's interpreter.  Entries are passed to ``pip
install`` verbatim, so offline clusters can use ``--no-index`` +local
paths.  ``conda``/``container`` stay unimplemented: this framework
targets hermetic TPU pod images, and those two mutate the interpreter
underneath torch; requesting them raises a clear error rather than
silently ignoring.
"""

from __future__ import annotations

import hashlib
import io
import os
import tempfile
import threading
import zipfile
from typing import Any, Dict, List, Optional, Tuple

# Blobs ride the control plane; keep them bounded.
MAX_PACKAGE_BYTES = 100 * 1024 * 1024
_EXCLUDE_DIRS = {"__pycache__", ".git", ".venv", "node_modules"}

_extract_lock = threading.Lock()


def package_dir(path: str) -> Tuple[bytes, str]:
    """Zip a directory into (blob, content_hash)."""
    path = os.path.abspath(os.path.expanduser(path))
    if not os.path.isdir(path):
        raise ValueError(f"runtime_env directory not found: {path}")
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        for root, dirs, files in os.walk(path):
            dirs[:] = [d for d in dirs if d not in _EXCLUDE_DIRS]
            for f in sorted(files):
                full = os.path.join(root, f)
                z.write(full, os.path.relpath(full, path))
    blob = buf.getvalue()
    if len(blob) > MAX_PACKAGE_BYTES:
        raise ValueError(
            f"runtime_env package {path} is {len(blob)} bytes "
            f"(cap {MAX_PACKAGE_BYTES}); ship large assets via the object "
            "store or shared storage instead")
    return blob, hashlib.sha256(blob).hexdigest()[:16]


def prepare_runtime_env(runtime_env: Optional[Dict[str, Any]]
                        ) -> Optional[Dict[str, Any]]:
    """Driver-side: resolve local paths into content-addressed blobs."""
    if not runtime_env:
        return runtime_env
    for key in ("conda", "container"):
        if runtime_env.get(key):
            raise NotImplementedError(
                f"runtime_env[{key!r}] is not supported: the port targets "
                "hermetic images (bake dependencies into the image); "
                "pip/working_dir/py_modules/env_vars are supported")
    out = dict(runtime_env)
    pip = out.get("pip") or out.get("uv")
    if pip is not None:
        if isinstance(pip, dict):
            # Ray's dict form: {"packages": [...], "pip_check": ...}.
            unknown = set(pip) - {"packages", "pip_check", "pip_version"}
            if unknown:
                raise NotImplementedError(
                    f"runtime_env pip dict keys {sorted(unknown)} are not "
                    "supported (packages/pip_check/pip_version only)")
            pip = pip.get("packages", [])
        if isinstance(pip, str):
            pip = [pip]
        out["pip"] = [str(p) for p in pip]
        out.pop("uv", None)
    wd = out.get("working_dir")
    if wd and not str(wd).startswith("pkg:"):
        blob, h = package_dir(wd)
        out["working_dir"] = f"pkg:{h}"
        out["_packages"] = dict(out.get("_packages", {}), **{h: blob})
    mods = out.get("py_modules")
    if mods:
        refs = []
        pkgs = dict(out.get("_packages", {}))
        for m in mods:
            if str(m).startswith("pkg:"):
                refs.append(m)
                continue
            blob, h = package_dir(m)
            pkgs[h] = blob
            refs.append(f"pkg:{h}")
        out["py_modules"] = refs
        out["_packages"] = pkgs
    return out


def _extract(pkg_hash: str, blob: bytes, session_dir: str) -> str:
    """Node-side: extract a package once per hash (content-addressed)."""
    dest = os.path.join(session_dir, "runtime_env", pkg_hash)
    with _extract_lock:
        if os.path.isdir(dest):
            return dest
        tmp = dest + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        with zipfile.ZipFile(io.BytesIO(blob)) as z:
            z.extractall(tmp)
        os.replace(tmp, dest)
    return dest


def node_setup_env_vars(runtime_env: Optional[Dict[str, Any]],
                        session_dir: Optional[str] = None
                        ) -> Dict[str, str]:
    """Node-side: extract packages, return spawn-time env vars the worker
    applies at boot (RAY_TPU_WORKING_DIR / RAY_TPU_PY_MODULES)."""
    if not runtime_env:
        return {}
    session_dir = session_dir or os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch_session")
    pkgs = runtime_env.get("_packages", {})
    env: Dict[str, str] = {}
    wd = runtime_env.get("working_dir")
    if wd and str(wd).startswith("pkg:"):
        h = str(wd)[4:]
        if h not in pkgs:
            raise ValueError(f"working_dir package {h} missing its blob")
        env["RAY_TPU_WORKING_DIR"] = _extract(h, pkgs[h], session_dir)
    mods: List[str] = []
    for m in runtime_env.get("py_modules") or ():
        if str(m).startswith("pkg:"):
            h = str(m)[4:]
            if h not in pkgs:
                raise ValueError(f"py_modules package {h} missing its blob")
            mods.append(_extract(h, pkgs[h], session_dir))
    if mods:
        env["RAY_TPU_PY_MODULES"] = os.pathsep.join(mods)
    pip = runtime_env.get("pip")
    if pip:
        venv = _ensure_pip_env(list(pip), session_dir)
        # The spawner execs this interpreter for the worker (node.py reads
        # RAY_TPU_PYTHON out of the spawn env).
        env["RAY_TPU_PYTHON"] = os.path.join(venv, "bin", "python")
    return env


_PIP_LOCKS: Dict[str, threading.Lock] = {}
_PIP_LOCKS_GUARD = threading.Lock()


def _local_fingerprint(path: str) -> str:
    """Content fingerprint for a local-path requirement so an edited
    package invalidates its cached venv (working_dir is content-addressed;
    pip local paths must be too or workers silently run stale code)."""
    h = hashlib.sha256()
    for root, dirs, files in os.walk(path):
        dirs[:] = sorted(d for d in dirs if d not in _EXCLUDE_DIRS)
        for f in sorted(files):
            full = os.path.join(root, f)
            try:
                st = os.stat(full)
            except OSError:
                continue
            h.update(f"{os.path.relpath(full, path)}:{st.st_size}:"
                     f"{st.st_mtime_ns}\n".encode())
    return h.hexdigest()[:16]


def pip_env_signature(requirements: List[str]) -> str:
    import sys
    parts = []
    for r in requirements:
        p = os.path.expanduser(r)
        if os.path.isdir(p):
            parts.append(f"{r}@{_local_fingerprint(p)}")
        else:
            parts.append(r)
    return hashlib.sha256(
        ("\n".join(parts) + sys.executable).encode()).hexdigest()[:16]


def pip_env_ready(runtime_env: Optional[Dict[str, Any]],
                  session_dir: Optional[str] = None) -> bool:
    """True when the env's venv already exists (fast-path probe so the
    dispatch thread can decide to offload a cold build)."""
    pip = (runtime_env or {}).get("pip")
    if not pip:
        return True
    session_dir = session_dir or os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch_session")
    return os.path.isdir(os.path.join(
        session_dir, "runtime_env", f"venv_{pip_env_signature(list(pip))}"))


def _ensure_pip_env(requirements: List[str], session_dir: str) -> str:
    """Create (once per signature) a venv layering ``requirements`` over
    the system site-packages (reference: runtime_env/pip.py — per-env
    virtualenv keyed by the requirement hash; concurrent setups are
    deduplicated in-process by a lock and cross-process by flock)."""
    import subprocess
    import sys

    sig = pip_env_signature(requirements)
    dest = os.path.join(session_dir, "runtime_env", f"venv_{sig}")
    with _PIP_LOCKS_GUARD:
        lock = _PIP_LOCKS.setdefault(sig, threading.Lock())
    # The venv build intentionally runs under the per-signature lock:
    # holding it IS the dedup (only same-env requests convoy, and they
    # must — the alternative is N racing builds of one venv).
    with lock, _file_lock(dest + ".lock"):  # ray-tpu: noqa[RT201]
        if os.path.isdir(dest):
            return dest
        tmp = dest + ".tmp"
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)  # stale partial build
        try:
            subprocess.run(
                [sys.executable, "-m", "venv", "--system-site-packages",
                 tmp],
                check=True, capture_output=True, timeout=300)
            # --system-site-packages only exposes the BASE interpreter's
            # site dir; when this process itself runs in a venv (common:
            # /opt/venv images), the parent's packages (torch, numpy,
            # setuptools) would vanish.  A .pth appends the parent's site
            # dirs after the new venv's own, so pip-installed extras still
            # shadow the base.
            import sysconfig
            parent_sites = [sysconfig.get_paths()["purelib"]]
            try:
                import site as _site
                parent_sites += _site.getsitepackages()
            except Exception:  # noqa: BLE001
                pass
            vpure = subprocess.run(
                [os.path.join(tmp, "bin", "python"), "-c",
                 "import sysconfig; print(sysconfig.get_paths()['purelib'])"],
                check=True, capture_output=True, text=True,
                timeout=60).stdout.strip()
            with open(os.path.join(vpure, "_ray_tpu_parent_env.pth"),
                      "w") as f:
                f.write("\n".join(dict.fromkeys(
                    p for p in parent_sites if p != vpure)) + "\n")
            # Prefer uv when the binary exists (reference:
            # runtime_env/uv.py) — the resolver/installer is an order of
            # magnitude faster than pip for cold venvs; pip remains the
            # fallback so images without uv behave identically.
            import shutil as _sh
            uv = _sh.which("uv")
            if uv:
                subprocess.run(
                    [uv, "pip", "install", "--quiet", "--python",
                     os.path.join(tmp, "bin", "python"), *requirements],
                    check=True, capture_output=True, timeout=600)
            else:
                subprocess.run(
                    [os.path.join(tmp, "bin", "python"), "-m", "pip",
                     "install", "--quiet", *requirements],
                    check=True, capture_output=True, timeout=600)
        except (subprocess.CalledProcessError,
                subprocess.TimeoutExpired) as e:
            shutil.rmtree(tmp, ignore_errors=True)
            from .exceptions import RuntimeEnvSetupError
            stderr = getattr(e, "stderr", b"") or b""
            if isinstance(stderr, str):
                stderr = stderr.encode()
            raise RuntimeEnvSetupError(
                f"pip runtime_env setup failed: "
                f"{type(e).__name__}: "
                f"{stderr.decode(errors='replace')[-2000:]}") from e
        os.replace(tmp, dest)
    return dest


class _file_lock:
    """flock-based cross-process mutex (two node processes on one host
    share the venv cache dir)."""

    def __init__(self, path: str):
        self._path = path
        self._f = None

    def __enter__(self):
        import fcntl
        os.makedirs(os.path.dirname(self._path), exist_ok=True)
        self._f = open(self._path, "w")
        fcntl.flock(self._f, fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc):
        import fcntl
        try:
            fcntl.flock(self._f, fcntl.LOCK_UN)
        finally:
            self._f.close()
        return False


def apply_worker_env() -> None:
    """Worker boot: chdir into working_dir, prepend py_modules to sys.path
    (reference: working_dir/py_modules activation in the worker setup)."""
    import sys
    wd = os.environ.get("RAY_TPU_WORKING_DIR")
    if wd:
        os.chdir(wd)
        if wd not in sys.path:
            sys.path.insert(0, wd)
    mods = os.environ.get("RAY_TPU_PY_MODULES")
    if mods:
        for m in reversed(mods.split(os.pathsep)):
            if m and m not in sys.path:
                sys.path.insert(0, m)
