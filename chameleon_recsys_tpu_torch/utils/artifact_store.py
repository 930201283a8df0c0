"""Artifact-store seam for remote model/metric synchronization.

The reference couples its trainers to Google Cloud Storage: recursive
directory upload of metric CSV/JSON artifacts every N evals and warm-start by
downloading a previous job's checkpoints
(nar_module/nar/gcs_utils.py:22-109, nar_utils.py:42-77,
nar_trainer_gcom.py:450-459, 527-556).  Here the same workflow shape is a
small protocol with a local-filesystem default, so any remote backend (GCS,
S3, NFS) plugs in without touching the harness — and tests exercise the full
warm-start/periodic-sync path against a tmpdir.

The port's copy of ``chameleon_recsys_tpu/utils/artifact_store.py``; the
``google-cloud-storage`` import stays lazy, inside ``GCSArtifactStore``.
"""
from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import List, Optional, Protocol, runtime_checkable


@runtime_checkable
class ArtifactStore(Protocol):
    """upload/download a directory tree; existence check.

    ``filename_pattern`` filters like the reference's GCS helpers
    (gcs_utils.py:22-40: only files whose name contains the pattern move).
    """

    def upload_dir(
        self, local_dir, remote_path: str, filename_pattern: Optional[str] = None
    ) -> List[str]:
        ...

    def download_dir(
        self, remote_path: str, local_dir, filename_pattern: Optional[str] = None
    ) -> List[str]:
        ...

    def exists(self, remote_path: str) -> bool:
        ...


class LocalArtifactStore:
    """Filesystem-backed store: ``remote_path`` is a path under ``root``.

    The default backend (artifacts are plain files); also the test double for
    any remote implementation.
    """

    def __init__(self, root):
        self.root = Path(root)

    def _resolve(self, remote_path: str) -> Path:
        return self.root / remote_path

    @staticmethod
    def _copy_tree(src: Path, dst: Path, filename_pattern) -> List[str]:
        copied = []
        if not src.exists():
            return copied
        for item in sorted(src.rglob("*")):
            if not item.is_file():
                continue
            if filename_pattern and filename_pattern not in item.name:
                continue
            target = dst / item.relative_to(src)
            target.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy2(item, target)
            copied.append(str(target))
        return copied

    def upload_dir(self, local_dir, remote_path, filename_pattern=None):
        return self._copy_tree(
            Path(local_dir), self._resolve(remote_path), filename_pattern
        )

    def download_dir(self, remote_path, local_dir, filename_pattern=None):
        return self._copy_tree(
            self._resolve(remote_path), Path(local_dir), filename_pattern
        )

    def exists(self, remote_path) -> bool:
        return self._resolve(remote_path).exists()


class GCSArtifactStore:
    """Google Cloud Storage backend — the reference's actual remote channel
    (nar_module/nar/gcs_utils.py:22-109 moves bytes to/from ``gs://``).

    ``root`` is a ``gs://bucket[/prefix]`` URL; ``remote_path`` arguments are
    joined under it.  The ``google-cloud-storage`` package is imported
    lazily (it is optional); tests and alternative clients inject a
    compatible ``client`` (needs ``bucket(name)`` →
    ``list_blobs(prefix=)`` / ``blob(name)`` with
    ``upload_from_filename`` / ``download_to_filename`` / ``exists``).
    """

    def __init__(self, root: str, client=None):
        if not root.startswith("gs://"):
            raise ValueError(f"GCSArtifactStore root must be gs://…: {root}")
        rest = root[len("gs://"):]
        self.bucket_name, _, prefix = rest.partition("/")
        if not self.bucket_name:
            raise ValueError(f"no bucket in {root}")
        self.prefix = prefix.strip("/")
        if client is None:
            try:
                from google.cloud import storage  # optional dependency
            except ImportError as e:  # pragma: no cover - environment-specific
                raise ImportError(
                    "gs:// artifact stores need the google-cloud-storage "
                    "package (pip install google-cloud-storage), or pass an "
                    "explicit client="
                ) from e
            client = storage.Client()
        self._bucket = client.bucket(self.bucket_name)

    def _key(self, remote_path: str) -> str:
        remote_path = str(remote_path).strip("/")
        return f"{self.prefix}/{remote_path}" if self.prefix else remote_path

    def upload_dir(self, local_dir, remote_path, filename_pattern=None):
        base = self._key(remote_path)
        local_dir = Path(local_dir)
        uploaded = []
        if not local_dir.exists():
            return uploaded
        for item in sorted(local_dir.rglob("*")):
            if not item.is_file():
                continue
            if filename_pattern and filename_pattern not in item.name:
                continue
            key = f"{base}/{item.relative_to(local_dir).as_posix()}"
            self._bucket.blob(key).upload_from_filename(str(item))
            uploaded.append(f"gs://{self.bucket_name}/{key}")
        return uploaded

    def download_dir(self, remote_path, local_dir, filename_pattern=None):
        base = self._key(remote_path)
        local_dir = Path(local_dir).resolve()
        fetched = []
        for blob in self._bucket.list_blobs(prefix=base + "/"):
            rel = blob.name[len(base) + 1:]
            if not rel or rel.endswith("/"):
                continue
            if filename_pattern and filename_pattern not in rel.rsplit("/", 1)[-1]:
                continue
            target = local_dir / rel
            # a hostile/buggy blob key with '..' segments must not write
            # outside the download directory
            resolved = Path(os.path.normpath(target))
            if not str(resolved).startswith(str(local_dir) + os.sep):
                raise ValueError(f"blob escapes download dir: {blob.name!r}")
            target = resolved
            target.parent.mkdir(parents=True, exist_ok=True)
            blob.download_to_filename(str(target))
            fetched.append(str(target))
        return fetched

    def exists(self, remote_path) -> bool:
        base = self._key(remote_path)
        if self._bucket.blob(base).exists():
            return True
        return any(True for _ in self._bucket.list_blobs(prefix=base + "/"))


def open_artifact_store(root: str, client=None) -> ArtifactStore:
    """Factory keyed on the root URL scheme: ``gs://…`` → GCS backend,
    anything else → local filesystem (the reference switches the same way on
    its --model_dir/--gcs flags, nar_utils.py:42-77)."""
    if root.startswith("gs://"):
        return GCSArtifactStore(root, client=client)
    return LocalArtifactStore(root)


def warm_start_model_dir(
    store: ArtifactStore, remote_path: str, model_dir
) -> List[str]:
    """Download a previous run's checkpoint files into ``model_dir`` before
    training (the reference's --warmup_model_dir flow,
    nar_trainer_gcom.py:450-459, restricted there to checkpoint files — here
    the checkpoint is the single full-unit pickle, so the whole tree
    syncs)."""
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    if not store.exists(remote_path):
        return []
    return store.download_dir(remote_path, model_dir)
