"""The port's cold start from a checkpoint URL, held to the JAX package's
tests: a mirror of the URL cases of ``tests/test_coldstart.py`` with the
targets in ``repro_torch`` (restores land on the CPU, ``device="cpu"``).
``restore_pipelined`` agrees bit for bit with ``restore_naive`` and with the
local restore over a byte-range server, pins the checkpoint's version set
at restore start, and fails fast when that set changes mid-restore, the
server dies, or auth is denied.

Everything runs against a real loopback HTTP server, no mocks. The server
death case kills a server process and waits for it to exit, so every
socket the restore holds is gone before the restore goes on."""

import http.server as _http_server
import json
import os
import re
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import repro_torch.core as ra
from repro_torch import remote
from repro_torch.checkpoint import (
    ColdStartStats,
    load_checkpoint,
    restore_naive,
    restore_pipelined,
    save_checkpoint,
)
from repro_torch.checkpoint.store import flatten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def served(tmp_path):
    server = remote.serve(str(tmp_path), port=0)
    try:
        yield str(tmp_path), server.url
    finally:
        server.shutdown()
        server.server_close()
        remote.close_readers()
        remote.reset_shared_cache()


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": torch.from_numpy(rng.standard_normal((96, 64)).astype(np.float32)),
        "inner": {
            "b": torch.from_numpy(rng.standard_normal((64,)).astype(np.float32)),
            "k": torch.from_numpy(rng.standard_normal((32, 48)).astype(np.float32)),
        },
    }


def _like(tree):
    return {k: _like(v) if isinstance(v, dict) else torch.empty(v.shape, dtype=v.dtype)
            for k, v in tree.items()}


def _cold():
    remote.close_readers()
    remote.reset_shared_cache()


def _assert_trees_equal(a, b):
    fa, fb = flatten(a, "p"), flatten(b, "p")
    assert fa.keys() == fb.keys()
    for name in fa:
        assert fa[name].dtype == fb[name].dtype, name
        assert torch.equal(fa[name], fb[name]), name


# --------------------------------------------------- pipelined ≡ naive
@pytest.mark.parametrize("kw", [{}, {"chunked": True}, {"quantize": "u8"},
                                {"chunked": True, "quantize": "u8"}],
                         ids=["raw", "chunked", "u8", "chunked-u8"])
def test_pipelined_matches_naive_url_chunked_quant(served, kw):
    root, base = served
    tree = _tree(1)
    p = save_checkpoint(root, 1, tree, **kw)
    url = f"{base}/{os.path.basename(p)}"
    _cold()
    naive, _, _ = restore_naive(url, _like(tree), device="cpu")
    _cold()
    st = ColdStartStats()
    pipe, _, _ = restore_pipelined(url, _like(tree), device="cpu", stats=st)
    _assert_trees_equal(pipe, naive)
    local, _, _ = restore_pipelined(p, _like(tree), device="cpu")
    _assert_trees_equal(pipe, local)
    assert st.leaves == 3
    assert st.restore_s > 0
    assert st.dequant_leaves == (3 if "quantize" in kw else 0)


# ------------------------------------------------ version pins: fail fast
def test_url_overwrite_mid_restore_fails_fast(served):
    """Same-shape overwrite between pin and payload read: the stored bytes
    would parse fine, so only the ETag pin can catch it."""
    root, base = served
    tree = _tree(8)
    p = save_checkpoint(root, 1, tree, chunked=True, quantize="u8")
    url = f"{base}/{os.path.basename(p)}"
    leaf = os.path.join(p, "param__w.ra")

    def clobber():
        st = os.stat(leaf)
        os.utime(leaf, ns=(st.st_mtime_ns + 10_000_000, st.st_mtime_ns + 10_000_000))

    _cold()
    with pytest.raises(ra.RawArrayError, match="overwritten during restore"):
        restore_pipelined(url, _like(tree), device="cpu", _after_resolve=clobber)


def test_server_death_mid_restore_raises_not_hangs(tmp_path):
    tree = _tree(9)
    p = save_checkpoint(str(tmp_path), 1, tree, chunked=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.remote.server", str(tmp_path), "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env)
    killed = []

    def kill():
        proc.kill()
        proc.wait()  # the process and every socket it held are gone
        killed.append(True)

    try:
        base = re.search(r" at (http://\S+) ", proc.stdout.readline()).group(1)
        url = f"{base}/{os.path.basename(p)}"
        _cold()
        with pytest.raises(ra.RawArrayError):
            restore_pipelined(url, _like(tree), device="cpu", _after_resolve=kill)
        assert killed  # the pipeline got as far as the pin wave
    finally:
        if not killed:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        _cold()


class _DenyingHandler(_http_server.BaseHTTPRequestHandler):
    def _deny(self):
        body = b"denied\n"
        self.send_response(401)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    do_GET = do_HEAD = _deny

    def log_message(self, fmt, *args):
        pass


def test_auth_denial_fails_fast():
    srv = _http_server.ThreadingHTTPServer(("127.0.0.1", 0), _DenyingHandler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/step_00000001"
        with pytest.raises(remote.RemoteAuthError):
            restore_pipelined(url, _like(_tree()), device="cpu")
    finally:
        srv.shutdown()
        srv.server_close()
        t.join()
        _cold()


# ------------------------------------------- /stat listing + pinned readers
def test_stat_endpoint_lists_sizes_and_etags(served):
    root, base = served
    tree = _tree(10)
    p = save_checkpoint(root, 1, tree)
    rel = os.path.basename(p)
    with urllib.request.urlopen(f"{base}/stat/{rel}") as resp:
        assert resp.status == 200
        files = json.loads(resp.read())["files"]
    on_disk = {n for n in os.listdir(p) if os.path.isfile(os.path.join(p, n))}
    assert set(files) == on_disk
    for name, ent in files.items():
        assert ent["size"] == os.path.getsize(os.path.join(p, name))
        assert ent["etag"]

    with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen(f"{base}/stat/no_such_dir")
    with pytest.raises(urllib.error.HTTPError):  # escape attempt -> 404
        urllib.request.urlopen(f"{base}/stat/../etc")


def test_stat_dir_and_pinned_reader(served):
    root, base = served
    tree = _tree(11)
    p = save_checkpoint(root, 1, tree)
    dir_url = f"{base}/{os.path.basename(p)}"
    listing = remote.stat_dir(dir_url)
    assert "manifest.json" in listing

    # pinned construction skips the HEAD yet reads real bytes
    name = "param__w.ra"
    r = remote.get_reader(f"{dir_url}/{name}", pinned=listing[name])
    assert (r.size, r.etag) == listing[name]
    got = r.read_range(0, 8)
    with open(os.path.join(p, name), "rb") as f:
        assert got == f.read(8)

    # a stale pin fails loudly on the FIRST ranged response
    _cold()
    size, _ = listing[name]
    r2 = remote.get_reader(f"{dir_url}/{name}", pinned=(size, '"stale-0"'))
    with pytest.raises(ra.RawArrayError, match="changed on server"):
        r2.read_range(0, 8)

    with pytest.raises(ra.RawArrayError):
        remote.stat_dir(f"{base}/no_such_dir")


def test_prewarm_stats(served):
    root, base = served
    tree = {"big": torch.from_numpy(
        np.random.default_rng(0).standard_normal((512, 512)).astype(np.float32))}
    p = save_checkpoint(root, 1, tree, chunked=True)
    url = f"{base}/{os.path.basename(p)}"
    _cold()
    st = ColdStartStats()
    restore_pipelined(url, _like(tree), device="cpu", stats=st)
    assert st.prewarmed_conns >= 1
    _cold()
    st2 = ColdStartStats()
    restore_pipelined(url, _like(tree), device="cpu", prewarm=False, stats=st2)
    assert st2.prewarmed_conns == 0
    local = ColdStartStats()
    restore_pipelined(p, _like(tree), device="cpu", stats=local)
    assert local.prewarmed_conns == 0  # local leaves hold fds, no sockets


# ------------------------------------------------------------ racat inspect
def test_racat_inspect_checkpoint(served, capsys):
    from repro_torch.core.racat import main as racat_main

    root, base = served
    tree = _tree(12)
    p = save_checkpoint(root, 1, tree, chunked=True, quantize="u8")
    for where in (p, f"{base}/{os.path.basename(p)}"):
        assert racat_main(["inspect", where]) == 0
        out = capsys.readouterr().out
        assert "param__w" in out
        assert "param__inner__b" in out
        assert "u8" in out  # quant schema surfaced


def test_racat_header_leaves_torch_unloaded(served):
    root, base = served
    p = save_checkpoint(root, 1, _tree(13))
    code = ("import sys\n"
            "from repro_torch.core.racat import main\n"
            f"rc = main(['header', {base + '/' + os.path.basename(p) + '/param__w.ra'!r}])\n"
            "print('torch' in sys.modules, rc)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip().splitlines()[-1] == "False 0"
    assert "(96, 64)" in out.stdout or "[96, 64]" in out.stdout


# ------------------------------------------------ the URL entry points
def test_load_checkpoint_and_manager_on_a_url(tmp_path, monkeypatch):
    from repro_torch.checkpoint import CheckpointManager

    server = remote.serve(str(tmp_path), port=0, upload_token="tok")
    monkeypatch.setenv("RA_REMOTE_TOKEN", "tok")
    try:
        tree = _tree(14)
        tree["e"] = tree["w"].to(torch.bfloat16)
        mgr = CheckpointManager(f"{server.url}/run", keep=1)
        for step in (1, 2):
            mgr.save(step, tree, extra={"step": step})
        mgr.wait()
        # no client-side garbage collection on a URL: both steps stay
        assert sorted(os.listdir(tmp_path / "run")) == ["step_00000001", "step_00000002"]
        got, _, extra = load_checkpoint(f"{server.url}/run/step_00000002", _like(tree))
        _assert_trees_equal(got, tree)
        assert extra == {"step": 2}
    finally:
        server.shutdown()
        server.server_close()
        _cold()
