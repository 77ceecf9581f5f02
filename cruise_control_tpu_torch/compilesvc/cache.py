"""Persistent kernel-build cache manager (the JAX package's
``compilesvc/cache.py``).

The JAX package keeps XLA's persistent compilation cache under versioned
keys.  The port compiles one thing that outlives a process: the aggregate
kernel's shared library, which ``ops/aggregate.py`` builds with ``nvcc`` at
first use.  This manager decides where that library is built and loaded from
(through :func:`cruise_control_tpu_torch.ops.aggregate.set_build_dir`, the
one way to move it), with the JAX module's behaviour:

- **Versioned keys.**  Entries live under
  ``<root>/v<schema>/<platform>-<machine_fp>/torch-<ver>+cu<ver>``: a torch
  or CUDA upgrade or a host change lands in a fresh directory instead of
  loading a library built for another toolchain.  The JAX package's
  ``<stack>/<bucket>`` levels key XLA executables, which depend on the goals
  and shapes; the kernel library depends on neither, so it has no such
  levels (inside the directory, ``ops/aggregate.py`` names it by the hash of
  its source).
- **Eviction.**  Oldest-first by mtime down to ``max_bytes`` per activated
  directory.
- **Corruption-safe fallback.**  A directory whose manifest is unreadable
  or mismatched is quarantined (renamed aside) and recreated; any
  unexpected failure deactivates the cache for this process instead of
  raising — a broken cache must never take down a solve.

The default is off: the library is then built in the git-ignored
``ops/_build/`` of the checkout, which a fresh checkout (a new release
directory) starts without.  The cache's root outlives checkouts, so a
release's first start loads the library instead of running ``nvcc``.  A
process loads the library once, so :meth:`activate` after that load moves
the build only for later processes, and :meth:`stats` says so.  Nothing is
compiled for the CPU, so a CPU activation stays off with that reason in
:meth:`stats` (the JAX package's CPU loader probe has no counterpart).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Dict, Optional

LOG = logging.getLogger(__name__)

SCHEMA_VERSION = 1
_MANIFEST = "cc-cache-manifest.json"


def machine_fingerprint() -> str:
    """Short stable fingerprint of the host the libraries target."""
    import platform
    import sys
    raw = "|".join((platform.machine(), platform.processor() or "",
                    platform.system(),
                    f"py{sys.version_info[0]}.{sys.version_info[1]}"))
    return hashlib.sha256(raw.encode()).hexdigest()[:12]


def toolchain_version() -> str:
    """``<torch version>+cu<CUDA version>``: the key part that stands where
    the JAX package's ``jaxlib-<ver>`` stands."""
    import torch
    return f"{torch.__version__.split('+')[0]}+cu{torch.version.cuda or 'none'}"


def default_root() -> str:
    root = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return os.path.join(root, "cruise_control_tpu_torch", "compile_cache")


def _default_platform() -> str:
    import torch
    return "cuda" if torch.cuda.is_available() else "cpu"


class PersistentCompileCache:
    def __init__(self, root: Optional[str] = None,
                 max_bytes: int = 4 << 30,
                 enabled: bool = False):
        self.root = root or default_root()
        self.max_bytes = int(max_bytes)
        self.enabled = bool(enabled)
        self.active_dir: Optional[str] = None
        self.last_warm: bool = False
        # Why the last activation left the cache off, or where it applies.
        self.inactive_reason: Optional[str] = None
        self.applies_to: Optional[str] = None

    # ------------------------------------------------------------ keying

    def cache_dir(self, platform_name: str) -> str:
        return os.path.join(
            self.root, f"v{SCHEMA_VERSION}",
            f"{platform_name}-{machine_fingerprint()}",
            f"torch-{toolchain_version()}")

    def _manifest(self) -> Dict:
        return {"schema": SCHEMA_VERSION, "torch": toolchain_version(),
                "fingerprint": machine_fingerprint()}

    # ---------------------------------------------------------- lifecycle

    def _off(self, reason: Optional[str]) -> bool:
        self.active_dir = None
        self.last_warm = False
        self.inactive_reason = reason
        self.applies_to = None
        return False

    def activate(self, platform_name: Optional[str] = None) -> bool:
        """Point the aggregate kernel's build at the versioned entry
        directory.  Returns True when the entry already holds a library
        ("warm").  Never raises: any failure logs and leaves the cache off.
        """
        if not self.enabled:
            return self._off("compile.persistent.cache.enabled=false")
        try:
            if platform_name is None:
                platform_name = _default_platform()
            if platform_name == "cpu":
                return self._off("nothing is compiled for the CPU")
            path = self.cache_dir(platform_name)
            os.makedirs(path, exist_ok=True)
            self._validate_or_quarantine(path)
            os.makedirs(path, exist_ok=True)
            self.evict(path)
            warm = any(e.name != _MANIFEST for e in os.scandir(path))
            with open(os.path.join(path, _MANIFEST), "w") as f:
                json.dump(self._manifest(), f)
            from cruise_control_tpu_torch.ops import aggregate
            now = aggregate.set_build_dir(path)
            self.active_dir = path
            self.last_warm = warm
            self.inactive_reason = None
            self.applies_to = "this process" if now else "later processes"
            if not now:
                LOG.warning("the aggregate kernel is already loaded; the "
                            "persistent cache at %s serves later processes",
                            path)
            return warm
        except Exception as e:   # noqa: BLE001 — cache must never kill a solve
            LOG.warning("persistent compile cache unavailable (%s); "
                        "continuing without it", e)
            return self._off(f"error: {e}")

    def _validate_or_quarantine(self, path: str) -> None:
        """A manifest that cannot be read or does not match this process's
        versioned key means the directory was corrupted or written by an
        incompatible producer — move it aside rather than load from it."""
        manifest_path = os.path.join(path, _MANIFEST)
        populated = any(e.name != _MANIFEST for e in os.scandir(path))
        if not populated and not os.path.exists(manifest_path):
            return   # fresh directory
        try:
            with open(manifest_path) as f:
                manifest = json.load(f)
            if (manifest.get("schema") == SCHEMA_VERSION
                    and manifest.get("torch") == toolchain_version()
                    and manifest.get("fingerprint") == machine_fingerprint()):
                return
            reason = "manifest mismatch"
        except (OSError, ValueError):
            reason = "unreadable manifest"
        quarantine = path + ".quarantined"
        n = 0
        while os.path.exists(quarantine):
            n += 1
            quarantine = f"{path}.quarantined.{n}"
        os.rename(path, quarantine)
        LOG.warning("compile cache %s quarantined to %s (%s)", path,
                    quarantine, reason)

    def evict(self, path: Optional[str] = None) -> int:
        """Drop oldest entries until the directory fits ``max_bytes``;
        returns bytes removed."""
        path = path or self.active_dir
        if path is None or not os.path.isdir(path):
            return 0
        entries = []
        total = 0
        for e in os.scandir(path):
            if not e.is_file() or e.name == _MANIFEST:
                continue
            st = e.stat()
            entries.append((st.st_mtime, st.st_size, e.path))
            total += st.st_size
        removed = 0
        for _mtime, size, fp in sorted(entries):
            if total - removed <= self.max_bytes:
                break
            try:
                os.unlink(fp)
                removed += size
            except OSError:
                pass
        return removed

    # -------------------------------------------------------------- stats

    def stats(self) -> Dict:
        out: Dict = {"enabled": self.enabled, "root": self.root,
                     "max_bytes": self.max_bytes,
                     "active_dir": self.active_dir,
                     "warm": self.last_warm,
                     "inactive_reason": self.inactive_reason,
                     "applies_to": self.applies_to,
                     "entries": 0, "bytes": 0}
        if self.active_dir and os.path.isdir(self.active_dir):
            for e in os.scandir(self.active_dir):
                if e.is_file() and e.name != _MANIFEST:
                    out["entries"] += 1
                    out["bytes"] += e.stat().st_size
        return out
