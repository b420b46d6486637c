"""Hooks storage: user-defined ``selectEmbeddingProperties``.

Port of ``orama_core_tpu/engine/hooks.py`` (the reference's hook storage,
`sides/hooks.rs`). The JS execution tiers (the bundled ``minijs``
interpreter and the opt-in ``node`` subprocess) are not ported yet, so
installing a hook raises ``NotImplementedError``. Storage, listing and
deletion keep the reference's on-disk format (``hooks.json``), and a
collection without hooks runs exactly as in the reference.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from ..utils import atomic_write_json, ensure_dir, read_json

SELECT_EMBEDDING_PROPERTIES = "selectEmbeddingProperties"
VALID_HOOK_NAMES = (SELECT_EMBEDDING_PROPERTIES,)

_NOT_PORTED = "hooks: the JS runtime (minijs) is a later port slice"


class HookValidationError(ValueError):
    pass


class HooksRuntime:
    def __init__(
        self,
        data_dir: Optional[str] = None,
        allow_subprocess: Optional[bool] = None,
    ) -> None:
        self._lock = threading.Lock()
        # (collection, name) -> code (str) or python callable
        self._hooks: Dict[Tuple[str, str], Union[str, Callable]] = {}
        self.data_dir = data_dir
        if data_dir:
            self._load()

    # -- storage (reference: hooks.rs:129-185) -------------------------------

    def insert_hook(
        self, collection_id: str, name: str, code: Union[str, Callable]
    ) -> None:
        raise NotImplementedError(_NOT_PORTED)

    def get_hook(self, collection_id: str, name: str):
        with self._lock:
            return self._hooks.get((collection_id, name))

    def list_hooks(self, collection_id: str) -> Dict[str, str]:
        with self._lock:
            return {
                n: c for (cid, n), c in self._hooks.items()
                if cid == collection_id
            }

    def delete_hook(self, collection_id: str, name: str) -> None:
        with self._lock:
            self._hooks.pop((collection_id, name), None)
        self._persist()

    # -- execution ------------------------------------------------------------

    def eval(
        self, collection_id: str, name: str, document: Dict[str, Any]
    ) -> Optional[Union[List[str], str]]:
        if self.get_hook(collection_id, name) is None:
            return None
        # a hook persisted by the reference package: it cannot run here
        raise NotImplementedError(_NOT_PORTED)

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
        atomic_write_json(
            os.path.join(ensure_dir(self.data_dir), "hooks.json"), data
        )

    def _load(self) -> None:
        data = read_json(os.path.join(self.data_dir, "hooks.json"))
        if not data:
            return
        with self._lock:
            for h in data:
                self._hooks[(h["collection"], h["name"])] = h["code"]
