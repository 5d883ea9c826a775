"""Raw-document blob store (reference: svc-src/nxsearch_storage.lua).

Optional storage of the original document text so search results can
be returned with content (``?store`` on add, ``?fetch`` on search).
Documents live under ``data/<index>/docs/<id%16 hex>/<(id//16)%256
hex>/<id>`` -- the same two-level sharded layout as the reference
(nxsearch_storage.lua:14-18), bounding per-directory fanout.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

from ..utils.validate import str_isalnumdu


class BlobStore:
    """Per-basedir raw document storage."""

    def __init__(self, basedir: str):
        self.basedir = basedir

    def _docs_dir(self, index_name: str) -> str:
        # Defense in depth: never build paths from unvalidated names
        # (the service validates too); "." or ".." would escape the
        # managed data/<index>/ tree.
        if not index_name or not str_isalnumdu(index_name):
            raise ValueError(f"invalid index name: {index_name!r}")
        return os.path.join(self.basedir, "data", index_name, "docs")

    def _doc_path(self, index_name: str, doc_id: int) -> str:
        l1 = doc_id % 16
        l2 = (doc_id // 16) % 256
        return os.path.join(self._docs_dir(index_name),
                            f"{l1:x}", f"{l2:02x}", str(doc_id))

    def store(self, index_name: str, doc_id: int, content: bytes) -> None:
        path = self._doc_path(index_name, doc_id)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(content)

    def fetch(self, index_name: str, doc_id: int) -> Optional[str]:
        try:
            with open(self._doc_path(index_name, doc_id), "rb") as f:
                return f.read().decode("utf-8", errors="replace")
        except OSError:
            return None

    def remove(self, index_name: str, doc_id: int) -> None:
        try:
            os.unlink(self._doc_path(index_name, doc_id))
        except OSError:
            pass

    def destroy_index(self, index_name: str) -> None:
        """Recursive delete of an index's blobs (storage.lua:119-127)."""
        shutil.rmtree(self._docs_dir(index_name), ignore_errors=True)
