"""JS hooks runtime: user-defined ``selectEmbeddingProperties``.

Counterpart of the reference's hook storage + embedded V8
(`sides/hooks.rs`, `src/js/deno.rs`): one hook kind exists —
``selectEmbeddingProperties(document)`` returning either a list of property
names or a string to embed (hooks.rs:30-33, fields.rs:410-485).

This image has no JS engine (no node/deno/quickjs, and V8 embedding is out
of scope for the search kernels — SURVEY.md §2.3), so execution is tiered:

1. a ``node`` binary, if present, runs the real JS in a subprocess;
2. otherwise a conservative static evaluator handles the dominant hook
   shape — a function whose body returns a constant array/string literal;
3. anything dynamic without node raises a clear error at insert time
   (validation still happens at hook-creation time, mirroring the
   reference's oxc parse check, hooks.rs:104-112).

Python hooks (callables) are also accepted natively — the in-process
TPU engine's idiomatic extension point.

Port of ``orama_core_tpu/engine/hooks.py``: host code, copied line for
line; the bundled interpreter is the port's own copy
(``engine/minijs.py``), and ``hooks.json`` keeps the reference's format,
so a file written by either package loads and runs in the other.
"""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from ..utils import atomic_write_json, ensure_dir, read_json

SELECT_EMBEDDING_PROPERTIES = "selectEmbeddingProperties"
VALID_HOOK_NAMES = (SELECT_EMBEDDING_PROPERTIES,)

_RETURN_LITERAL = re.compile(r"return\s+(\[[^;]*\]|'[^']*'|\"[^\"]*\")\s*;?", re.S)
_UNSUPPORTED = object()  # minijs couldn't run the hook (outside the subset)


class HookValidationError(ValueError):
    pass


def _validate_js(code: str) -> None:
    if SELECT_EMBEDDING_PROPERTIES not in code:
        raise HookValidationError(
            f"hook must define {SELECT_EMBEDDING_PROPERTIES}"
        )
    for open_c, close_c in (("{", "}"), ("(", ")"), ("[", "]")):
        if code.count(open_c) != code.count(close_c):
            raise HookValidationError(f"unbalanced {open_c}{close_c} in hook code")


def _static_eval(code: str) -> Optional[Union[List[str], str]]:
    """Extract a constant return value without a JS engine."""
    mo = _RETURN_LITERAL.search(code)
    if not mo:
        return None
    literal = mo.group(1)
    try:
        # JS array/string literals of strings are close enough to Python's
        value = ast.literal_eval(literal)
    except (ValueError, SyntaxError):
        try:
            value = json.loads(literal.replace("'", '"'))
        except json.JSONDecodeError:
            return None
    if isinstance(value, str):
        return value
    if isinstance(value, (list, tuple)) and all(isinstance(x, str) for x in value):
        return list(value)
    return None


class HooksRuntime:
    def __init__(
        self,
        data_dir: Optional[str] = None,
        allow_subprocess: Optional[bool] = None,
    ) -> None:
        self._lock = threading.Lock()
        # (collection, name) -> code (str) or python callable
        self._hooks: Dict[Tuple[str, str], Union[str, Callable]] = {}
        # Subprocess node execution is OPT-IN: unlike the reference's
        # sandboxed embedded V8, `node -e` runs with full process privileges
        # (fs, network, env) — a write-api-key holder must not get arbitrary
        # code execution by default. Enable via allow_subprocess=True or
        # ORAMAX_HOOKS_SUBPROCESS=1; when enabled, node runs with its
        # permission model (no fs/net grants).
        if allow_subprocess is None:
            allow_subprocess = os.environ.get("ORAMAX_HOOKS_SUBPROCESS") == "1"
        self._node = shutil.which("node") if allow_subprocess else None
        self.data_dir = data_dir
        if data_dir:
            self._load()

    # -- storage (reference: hooks.rs:129-185) -------------------------------

    def insert_hook(self, collection_id: str, name: str, code: Union[str, Callable]) -> None:
        if name not in VALID_HOOK_NAMES:
            raise HookValidationError(f"unknown hook {name!r}")
        if isinstance(code, str):
            _validate_js(code)
            # validation mirrors the reference's oxc parse check
            # (hooks.rs:104-112): the bundled interpreter must parse it, or a
            # fallback tier must be able to run it
            if not self._parseable(code):
                raise HookValidationError(
                    "hook uses JS outside the supported subset "
                    "(engine/minijs.py) and no other execution tier can run "
                    "it; simplify the hook or register a Python callable"
                )
        with self._lock:
            self._hooks[(collection_id, name)] = code
        self._persist()

    def _parseable(self, code: str) -> bool:
        from . import minijs

        try:
            minijs._Parser(minijs._tokenize(code)).parse_program()
            return True
        except minijs.MiniJsError:
            pass
        if _static_eval(code) is not None:
            return True
        return self._node is not None

    def get_hook(self, collection_id: str, name: str):
        with self._lock:
            return self._hooks.get((collection_id, name))

    def list_hooks(self, collection_id: str) -> Dict[str, str]:
        with self._lock:
            return {
                n: (c if isinstance(c, str) else f"<python {getattr(c, '__name__', 'fn')}>")
                for (cid, n), c in self._hooks.items()
                if cid == collection_id
            }

    def delete_hook(self, collection_id: str, name: str) -> None:
        with self._lock:
            self._hooks.pop((collection_id, name), None)
        self._persist()

    # -- execution (reference: js/deno.rs:29-101) ----------------------------

    def eval(
        self, collection_id: str, name: str, document: Dict[str, Any]
    ) -> Optional[Union[List[str], str]]:
        hook = self.get_hook(collection_id, name)
        if hook is None:
            return None
        if callable(hook):
            return hook(document)
        # JS hooks get a DEEP COPY: minijs supports member assignment /
        # push, and the reference's V8 boundary serializes the document —
        # a hook must never mutate what gets stored and indexed
        import copy

        document = copy.deepcopy(document)
        # tier 1: the bundled sandboxed interpreter (engine/minijs.py) — the
        # replacement for the reference's embedded V8 thread (js/deno.rs):
        # dynamic hooks run in-process with no host access and a step budget
        from . import minijs

        try:
            value = minijs.run_hook(hook, SELECT_EMBEDDING_PROPERTIES, document)
        except minijs.MiniJsThrow as th:
            # the hook RAN and vetoed this document — a per-doc failure
            # (caller skips the embedding), never a reason to re-run the
            # hook on another tier, which could take a different branch
            raise RuntimeError(f"hook threw: {th.value!r}") from None
        except minijs.MiniJsFatal as e:
            # budget kill: re-running a runaway hook elsewhere just burns
            # the node tier's 5 s timeout per document
            raise RuntimeError(f"hook exceeded budgets: {e}") from None
        except minijs.MiniJsError:
            value = _UNSUPPORTED
        if value is not _UNSUPPORTED:
            if value is None:
                return None  # hook declined: no override
            if isinstance(value, str):
                return value
            if isinstance(value, list) and all(isinstance(x, str) for x in value):
                return value
            raise RuntimeError(
                f"hook returned unsupported value {type(value).__name__}"
            )
        # Distinguish parse failures from runtime failures: a hook that
        # PARSES but hits an unsupported runtime feature (e.g. a missing
        # string method) must skip tier 2 — constant-return extraction
        # cannot follow branches, so it would silently return the first
        # `return` literal regardless of which branch this doc takes.
        parses = True
        try:
            minijs._Parser(minijs._tokenize(hook)).parse_program()
        except minijs.MiniJsError:
            parses = False
        if not parses:
            # tier 2: constant-return extraction (no engine needed at all)
            static = _static_eval(hook)
            if static is not None:
                return static
        if self._node is None:
            raise RuntimeError(
                "hook requires JS outside the supported subset: subprocess "
                "execution is disabled by default (opt in with "
                "ORAMAX_HOOKS_SUBPROCESS=1)"
            )
        # IIFE wrapper returning JSON — the deno runner's pattern; node runs
        # under its permission model (no fs/net/env-write grants)
        script = (
            f"{hook}\nconst __doc = {json.dumps(document)};\n"
            f"process.stdout.write(JSON.stringify("
            f"{SELECT_EMBEDDING_PROPERTIES}(__doc)));"
        )
        try:
            out = subprocess.run(
                [self._node, "--permission", "-e", script],
                capture_output=True,
                timeout=5.0,
                text=True,
            )
            if out.returncode != 0 and "--permission" in (out.stderr or ""):
                # older node without the permission model: refuse rather than
                # silently run unsandboxed
                raise RuntimeError(
                    "node lacks the permission model (--permission); "
                    "refusing to run hook unsandboxed"
                )
        except subprocess.TimeoutExpired as e:
            raise RuntimeError(f"hook timed out after {e.timeout}s") from None
        if out.returncode != 0:
            raise RuntimeError(f"hook failed: {out.stderr.strip()[:500]}")
        return json.loads(out.stdout)

    # -- persistence ----------------------------------------------------------

    def _persist(self) -> None:
        if not self.data_dir:
            return
        with self._lock:
            data = [
                {"collection": cid, "name": n, "code": c}
                for (cid, n), c in self._hooks.items()
                if isinstance(c, str)
            ]
        atomic_write_json(os.path.join(ensure_dir(self.data_dir), "hooks.json"), data)

    def _load(self) -> None:
        data = read_json(os.path.join(self.data_dir, "hooks.json"))
        if not data:
            return
        with self._lock:
            for h in data:
                self._hooks[(h["collection"], h["name"])] = h["code"]
