"""Svar-compatible configuration system.

Re-implements the semantics of the reference's GSLAM/GSLAM/core/Svar.h
(ParseMain/ParseFile/ParseLine at Svar.h:257-261) so that the reference's
`Default.cfg` / dataset `config.cfg` files load unchanged:

  key = value            assignment ($()/{} expanded at read time)
  key ?= value           default: only set if key absent
  include other.cfg      textual include (relative to the including file)
  if $(Key)=value        conditional block
  else / endif
  # comment   // comment
  $(Key) / ${Key}        expansion of previously set keys

CLI parsing (`parse_main`): `key=value` tokens override, `conf=<file>` selects
the config file (default Default.cfg in cwd), bare tokens are returned as
"unParsed" positional args (the reference opens them as datasets,
src/main.cpp:34-38).

The reference's typed references (GetInt returning live int&) are used as
cross-thread flags (SURVEY.md section 5); here modules simply hold the Svar
object and read keys when needed — Svar is thread-safe for that usage.

Also provides `Scommand`, the string RPC bus (Svar.h:332-353).
"""
from __future__ import annotations

import os
import re
import threading
from typing import Any, Callable, Dict, List, Optional

_EXPAND = re.compile(r"\$\(([^)]*)\)|\$\{([^}]*)\}")
_COMMENT = re.compile(r"(//|#).*$")


class Svar:
    def __init__(self, data: Optional[Dict[str, str]] = None):
        self._data: Dict[str, Any] = dict(data or {})
        self._lock = threading.RLock()
        self.unparsed: List[str] = []

    # ------------------------------------------------------------------ core
    def _expand(self, text: str) -> str:
        def sub(m):
            key = m.group(1) if m.group(1) is not None else m.group(2)
            return str(self._data.get(key.strip(), ""))
        prev = None
        # iterate: values may themselves contain $()
        for _ in range(8):
            if text == prev:
                break
            prev = text
            text = _EXPAND.sub(sub, text)
        return text

    def insert(self, key: str, value: Any, overwrite: bool = True):
        with self._lock:
            if overwrite or key not in self._data:
                self._data[key] = value

    def exist(self, key: str) -> bool:
        return key in self._data

    def erase(self, key: str):
        with self._lock:
            self._data.pop(key, None)

    def keys(self):
        return list(self._data.keys())

    # ----------------------------------------------------------- typed reads
    def get(self, key: str, default: Any = None) -> Any:
        with self._lock:
            if key not in self._data:
                if default is not None:
                    self._data[key] = default
                return default
            v = self._data[key]
            return self._expand(v) if isinstance(v, str) else v

    def get_string(self, key: str, default: str = "") -> str:
        v = self.get(key, default)
        return str(v)

    def get_int(self, key: str, default: int = 0) -> int:
        v = self.get(key, default)
        try:
            return int(float(str(v).strip()))
        except ValueError:
            return default

    def get_double(self, key: str, default: float = 0.0) -> float:
        v = self.get(key, default)
        try:
            return float(str(v).strip())
        except ValueError:
            return default

    def get_bool(self, key: str, default: bool = False) -> bool:
        return bool(self.get_int(key, int(default)))

    def get_vec(self, key: str, default=()) -> List[float]:
        """VecParament: whitespace/[],-separated float list."""
        s = self.get_string(key, "")
        if not s:
            return list(default)
        toks = re.split(r"[\s,;\[\]]+", s.strip())
        try:
            return [float(t) for t in toks if t]
        except ValueError:
            return list(default)

    def set(self, key: str, value: Any):
        self.insert(key, value, overwrite=True)

    def update(self, other: "Svar"):
        with self._lock:
            self._data.update(other._data)

    # --------------------------------------------------------------- parsing
    def parse_line(self, line: str, overwrite: bool = True) -> bool:
        """Parse one `key=value` / `key?=value` statement."""
        line = _COMMENT.sub("", line).strip()
        if not line:
            return False
        if "?=" in line:
            k, _, v = line.partition("?=")
            self.insert(k.strip(), v.strip(), overwrite=False)
            return True
        if "=" in line:
            k, _, v = line.partition("=")
            k = k.strip()
            if k and " " not in k:
                self.insert(k, v.strip(), overwrite=overwrite)
                return True
        return False

    def parse_file(self, path: str) -> bool:
        if not os.path.isfile(path):
            return False
        base = os.path.dirname(os.path.abspath(path))
        with open(path, "r", errors="replace") as f:
            lines = f.readlines()
        # conditional stack: each entry is (taking_branch, any_branch_taken)
        stack: List[List[bool]] = []

        def active() -> bool:
            return all(s[0] for s in stack)

        for raw in lines:
            line = _COMMENT.sub("", raw).strip()
            if not line:
                continue
            low = line.split()
            if low[0] == "if":
                cond = " ".join(low[1:])
                taken = False
                if active():
                    if "=" in cond:
                        lhs, _, rhs = cond.partition("=")
                        taken = self._expand(lhs.strip()) == self._expand(rhs.strip())
                    else:
                        taken = self._expand(cond.strip()) not in ("", "0")
                stack.append([taken, taken])
                continue
            if low[0] == "else":
                if stack:
                    stack[-1][0] = (not stack[-1][1]) and all(s[0] for s in stack[:-1])
                    stack[-1][1] = stack[-1][1] or stack[-1][0]
                continue
            if low[0] == "endif":
                if stack:
                    stack.pop()
                continue
            if not active():
                continue
            if low[0] == "include" and len(low) > 1:
                inc = self._expand(low[1])
                if not os.path.isabs(inc):
                    inc = os.path.join(base, inc)
                self.parse_file(inc)
                continue
            self.parse_line(line)
        return True

    def parse_main(self, argv: List[str]) -> List[str]:
        """Reference ParseMain: key=value overrides, conf= selects file,
        bare tokens are returned (and stored in self.unparsed)."""
        overrides = Svar()
        positional = []
        for a in argv:
            if "=" in a and not a.startswith("-"):
                overrides.parse_line(a)
            elif a.startswith("--") and "=" in a:
                overrides.parse_line(a[2:])
            else:
                positional.append(a)
        conf = overrides._data.get("conf", self._data.get("conf", "Default.cfg"))
        if os.path.isfile(str(conf)):
            self.parse_file(str(conf))
        self.update(overrides)  # CLI wins over file
        self.unparsed = positional
        return positional

    def dump(self) -> str:
        with self._lock:
            return "\n".join(f"{k}={self._data[k]}" for k in sorted(self._data))


class Scommand:
    """String command bus (Svar.h Scommand): register named handlers, call
    them with a parameter string. Used to wire GUI<->SLAM<->mosaic commands in
    the reference; here it wires pipeline stages and the exporter."""

    def __init__(self):
        self._handlers: Dict[str, Callable[[str], None]] = {}
        self._lock = threading.Lock()

    def register(self, name: str, fn: Callable[[str], None]):
        with self._lock:
            self._handlers[name] = fn

    def call(self, command: str):
        parts = command.split(None, 1)
        if not parts:
            return
        name, params = parts[0], (parts[1] if len(parts) > 1 else "")
        with self._lock:
            fn = self._handlers.get(name)
        if fn is not None:
            fn(params)


# process-global instances, mirroring the reference's `svar` / `scommand`
svar = Svar()
scommand = Scommand()
