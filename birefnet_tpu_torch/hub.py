"""HuggingFace-hub weight fetch with local caching.

Counterpart of birefnet_tpu/hub.py, copied so that the port needs nothing
of the JAX package: fetch `ZhengPeng7/BiRefNet / model.safetensors` once,
cache it under the `~/.cache/huggingface/hub` layout that the hf-hub crate
and huggingface_hub use (the same paths as the JAX package's for the same
root), and return the cached path on later calls.

Uses stdlib urllib only (no `huggingface_hub` dependency); resumes a
partial download through HTTP Range, validated by the ETag sent as
If-Range. The `endpoint` parameter lets tests run the whole code path
against a local HTTP server; the default is huggingface.co.
"""

from __future__ import annotations

import os
import sys
import urllib.error
import urllib.request

DEFAULT_REPO = "ZhengPeng7/BiRefNet"
DEFAULT_FILE = "model.safetensors"
DEFAULT_ENDPOINT = "https://huggingface.co"
_CHUNK = 1 << 20


class HubUnavailableError(RuntimeError):
    """Raised when the hub endpoint cannot be reached (offline env)."""


def cache_dir(repo_id: str = DEFAULT_REPO, root: str | None = None) -> str:
    """The hf-hub cache directory for a repo (same layout as the reference's
    hf-hub crate and huggingface_hub)."""
    root = root or os.path.join(
        os.path.expanduser("~"), ".cache", "huggingface", "hub")
    return os.path.join(root, "models--" + repo_id.replace("/", "--"))


def cached_file(repo_id: str = DEFAULT_REPO, filename: str = DEFAULT_FILE,
                root: str | None = None) -> str | None:
    """Return the cached path for repo_id/filename if present, else None."""
    snaps = os.path.join(cache_dir(repo_id, root), "snapshots")
    if not os.path.isdir(snaps):
        return None
    for snap in sorted(os.listdir(snaps)):
        cand = os.path.join(snaps, snap, filename)
        if os.path.exists(cand):
            return cand
    return None


def download(repo_id: str = DEFAULT_REPO, filename: str = DEFAULT_FILE,
             root: str | None = None, endpoint: str = DEFAULT_ENDPOINT,
             revision: str = "main", progress: bool = True) -> str:
    """Fetch repo_id/filename into the hf-hub cache; return the local path.

    Mirrors the reference's `Api::model(...).get(...)` behavior
    (reference: examples/infer_image.rs:30-32): cached-after-first-run,
    atomic (download to .partial, rename when complete), resumable.
    Raises HubUnavailableError when the endpoint is unreachable so callers
    can print an actionable offline message.
    """
    cached = cached_file(repo_id, filename, root)
    if cached is not None:
        return cached

    url = f"{endpoint}/{repo_id}/resolve/{revision}/{filename}"
    snap_dir = os.path.join(cache_dir(repo_id, root), "snapshots", revision)
    os.makedirs(snap_dir, exist_ok=True)
    dest = os.path.join(snap_dir, filename)
    partial = dest + ".partial"

    # Resume validation: a Range resume is only safe if the remote file is
    # unchanged since the partial was written. The ETag observed at the start
    # of the download is stored next to the .partial; on resume it is sent as
    # If-Range so the server returns 206 only when the validator still
    # matches (a changed file yields 200 -> full restart). A partial with no
    # stored validator is discarded rather than trusted.
    etag_path = partial + ".etag"
    offset = os.path.getsize(partial) if os.path.exists(partial) else 0
    etag = None
    if offset and os.path.exists(etag_path):
        with open(etag_path, "r", encoding="utf-8") as f:
            etag = f.read().strip() or None
    if offset and etag is None:
        offset = 0  # unvalidatable partial: restart from scratch
    req = urllib.request.Request(url)
    if offset:
        req.add_header("Range", f"bytes={offset}-")
        req.add_header("If-Range", etag)
    try:
        resp = urllib.request.urlopen(req, timeout=30)
    except (urllib.error.URLError, OSError) as e:
        raise HubUnavailableError(
            f"cannot reach {endpoint} to fetch {repo_id}/{filename}: {e}. "
            f"Download it elsewhere and pass --checkpoint, or place it at "
            f"{dest}") from e

    if offset and resp.status != 206:
        offset = 0  # Range refused or file changed (If-Range): full restart
    if not offset:
        new_etag = resp.headers.get("ETag")
        if new_etag:
            with open(etag_path, "w", encoding="utf-8") as f:
                f.write(new_etag)
        elif os.path.exists(etag_path):
            os.remove(etag_path)
    mode = "ab" if offset else "wb"
    total = resp.headers.get("Content-Length")
    total = int(total) + offset if total else None
    done = offset
    with open(partial, mode) as f:
        while True:
            chunk = resp.read(_CHUNK)
            if not chunk:
                break
            f.write(chunk)
            done += len(chunk)
            if progress and total:
                pct = 100.0 * done / total
                print(f"\rdownloading {filename}: {pct:5.1f}% "
                      f"({done >> 20} MiB)", end="", file=sys.stderr)
    if progress and total:
        print(file=sys.stderr)
    if total is not None and done != total:
        raise HubUnavailableError(
            f"truncated download of {url}: got {done} of {total} bytes "
            f"(partial kept at {partial}; rerun to resume)")
    os.replace(partial, dest)
    if os.path.exists(etag_path):
        os.remove(etag_path)
    return dest
