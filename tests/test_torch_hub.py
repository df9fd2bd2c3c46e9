"""The port's hf-hub fetch (birefnet_tpu_torch/hub.py) against the JAX
package's (birefnet_tpu/hub.py).

Every case of tests/test_hub.py runs against the port's `download` on a
local HTTP server on 127.0.0.1 (nothing goes to the network): the cache
layout, the second call served from the cache, the resume through
If-Range, a stale ETag restarting, a partial with no validator
discarded, and the offline error. The cache paths equal the JAX
functions' for the same root.
"""

import http.server
import os
import threading

import pytest

from birefnet_tpu import hub as jhub
from birefnet_tpu_torch import hub

PAYLOAD = os.urandom(3 << 20)  # 3 MiB, spans multiple chunks


class _RangeHandler(http.server.BaseHTTPRequestHandler):
    hits = 0
    ranged_hits = 0
    etag = '"payload-v1"'

    def do_GET(self):
        type(self).hits += 1
        rng = self.headers.get("Range")
        if_range = self.headers.get("If-Range")
        # RFC 7233 If-Range: honor Range only when the validator matches.
        if rng and (if_range is None or if_range == self.etag):
            type(self).ranged_hits += 1
            start = int(rng.split("=")[1].rstrip("-"))
            body = PAYLOAD[start:]
            self.send_response(206)
        else:
            body = PAYLOAD
            self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("ETag", self.etag)
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


@pytest.fixture()
def server():
    httpd = http.server.HTTPServer(("127.0.0.1", 0), _RangeHandler)
    t = threading.Thread(target=httpd.serve_forever,
                         kwargs={"poll_interval": 0.05}, daemon=True)
    t.start()
    _RangeHandler.hits = 0
    _RangeHandler.ranged_hits = 0
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=10)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_download_and_cache_layout(tmp_path, server):
    path = hub.download("Org/Repo", "model.safetensors", root=str(tmp_path),
                        endpoint=server, progress=False)
    assert "models--Org--Repo" in path and "snapshots" in path
    assert _read(path) == PAYLOAD
    assert hub.cached_file("Org/Repo", "model.safetensors",
                           root=str(tmp_path)) == path
    # The JAX package finds the port's download, and at the same path.
    assert jhub.cached_file("Org/Repo", "model.safetensors",
                            root=str(tmp_path)) == path


def test_second_call_uses_cache(tmp_path, server):
    hub.download("Org/Repo", "model.safetensors", root=str(tmp_path),
                 endpoint=server, progress=False)
    hits = _RangeHandler.hits
    p2 = hub.download("Org/Repo", "model.safetensors", root=str(tmp_path),
                      endpoint=server, progress=False)
    assert _RangeHandler.hits == hits  # no new request
    assert _read(p2) == PAYLOAD


def _write_partial(tmp_path, etag=None):
    snap = os.path.join(hub.cache_dir("Org/Repo", str(tmp_path)),
                        "snapshots", "main")
    os.makedirs(snap)
    partial = os.path.join(snap, "model.safetensors.partial")
    with open(partial, "wb") as f:
        f.write(PAYLOAD[: 1 << 20])  # first 1 MiB already fetched
    if etag is not None:
        with open(partial + ".etag", "w") as f:
            f.write(etag)
    return snap


def test_resume_from_partial(tmp_path, server):
    snap = _write_partial(tmp_path, etag=_RangeHandler.etag)
    path = hub.download("Org/Repo", "model.safetensors", root=str(tmp_path),
                        endpoint=server, progress=False)
    assert _read(path) == PAYLOAD
    assert _RangeHandler.ranged_hits == 1  # resumed (206)
    assert not os.path.exists(os.path.join(snap, "model.safetensors.partial"))
    assert not os.path.exists(
        os.path.join(snap, "model.safetensors.partial.etag"))


def test_resume_stale_etag_restarts(tmp_path, server):
    """A remote file changed since the partial (ETag mismatch): If-Range
    answers 200 and the download restarts instead of stitching."""
    _write_partial(tmp_path, etag='"payload-v0-outdated"')
    path = hub.download("Org/Repo", "model.safetensors", root=str(tmp_path),
                        endpoint=server, progress=False)
    assert _read(path) == PAYLOAD
    assert _RangeHandler.ranged_hits == 0


def test_resume_without_validator_discards_partial(tmp_path, server):
    _write_partial(tmp_path, etag=None)
    path = hub.download("Org/Repo", "model.safetensors", root=str(tmp_path),
                        endpoint=server, progress=False)
    assert _read(path) == PAYLOAD
    assert _RangeHandler.ranged_hits == 0  # no Range request was trusted


def test_offline_raises_actionable_error(tmp_path):
    with pytest.raises(hub.HubUnavailableError, match="--checkpoint"):
        hub.download("Org/Repo", "model.safetensors", root=str(tmp_path),
                     endpoint="http://127.0.0.1:9", progress=False)


@pytest.mark.parametrize("repo_id", [hub.DEFAULT_REPO, "Org/Repo"])
def test_cache_paths_equal_the_jax_packages(tmp_path, monkeypatch, repo_id):
    """cache_dir and cached_file give the JAX functions' paths, for an
    explicit root and for the default root under $HOME."""
    monkeypatch.setenv("HOME", str(tmp_path))
    assert hub.cache_dir(repo_id) == jhub.cache_dir(repo_id)
    assert (hub.cache_dir(repo_id, str(tmp_path))
            == jhub.cache_dir(repo_id, str(tmp_path)))
    assert hub.cached_file(repo_id) is None is jhub.cached_file(repo_id)
    for snap in ("b", "a"):
        d = os.path.join(jhub.cache_dir(repo_id), "snapshots", snap)
        os.makedirs(d)
        open(os.path.join(d, hub.DEFAULT_FILE), "wb").close()
    assert hub.cached_file(repo_id) == jhub.cached_file(repo_id)
    assert hub.cached_file(repo_id).endswith(
        os.path.join("snapshots", "a", hub.DEFAULT_FILE))
