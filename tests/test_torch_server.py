"""The port's serving daemon (``fastdepth_tpu_torch.engine.server`` and
``cli/serve.py``) on the CPU, where the kernels' plain versions run:

- every case of ``tests/test_server.py`` that needs no mesh, pointed at
  the port (``device='cpu'``); of the four mesh cases, the JAX server's
  validation messages (batch, height, chain with a data axis) and the
  serve CLI's spatial daemon launch over two spawned gloo ranks (the
  mesh servers' answers are held in ``tests/test_torch_spatial.py``);
- the port's server against the JAX package's on the same numpy tree
  (f32, uint8 in, f16 out, chain);
- the wire protocol both ways: the JAX package's clients against the
  port's daemon and the port's clients against the JAX daemon, and the
  framing bytes themselves;
- the serve CLI's client modes, its refusals and its default to the card.

Every wait is bounded (``fut.result(timeout=...)``, socket timeouts, and
a ``join(timeout)`` followed by an assert that the thread is dead)."""

import io
import json
import os
import pickle
import socket
import sys
import threading
import time
from concurrent.futures import Future, wait

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fastdepth_tpu.engine import server as JS
from fastdepth_tpu.models import build as jax_build
from fastdepth_tpu_torch.checkpoint import params_to_jax, save_checkpoint
from fastdepth_tpu_torch.cli import serve as serve_cli
from fastdepth_tpu_torch.config import ModelConfig
from fastdepth_tpu_torch.engine import server as srv_mod
from fastdepth_tpu_torch.engine.aot import _prepare
from fastdepth_tpu_torch.engine.server import (
    InferenceServer,
    _resolve_future,
    normalize,
    parse_address,
    request,
    request_stats,
    request_stream,
    serve_tcp,
    serve_unix_socket,
)
from fastdepth_tpu_torch.models import build
from fastdepth_tpu_torch.models.fastdepth import make_fastdepth
from fastdepth_tpu_torch.ops.cuda.kernel import COUNTER
import torch_threads  # noqa: F401  (torch's CPU threads: a share per xdist worker)
from torch_port_config import to_jax

TINY_ENC = (4, 6, 8, 10, 12, 14, 16, 16, 16, 16, 16, 16, 20, 24)
TINY_DEC = (18, 14, 10, 6, 4)
CFG = ModelConfig(encoder_channels=TINY_ENC, decoder_channels=TINY_DEC)
HW = 64
RESULT_S = 60  # the longest any future or client call is waited for
JOIN_S = 10  # the longest any thread join waits


def _quiet(*a):
    pass


@pytest.fixture(scope="module")
def state_dict():
    """A seeded unfolded tree (He-scaled convs, BatchNorm statistics away
    from their defaults so the fold matters) as a flat state dict."""
    rng = np.random.RandomState(0)
    sd = {}
    for key, v in make_fastdepth(CFG, folded=False).state_dict().items():
        shape, leaf = tuple(v.shape), key.rsplit(".", 1)[-1]
        if leaf == "w":
            a = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif leaf == "scale":
            a = 1.0 + 0.1 * rng.randn(*shape)
        elif leaf == "var":
            a = 1.0 + 0.2 * rng.rand(*shape)
        else:  # bias, mean
            a = 0.1 * rng.randn(*shape)
        sd[key] = torch.from_numpy(a.astype(np.float32))
    return sd


@pytest.fixture(scope="module")
def tiny(state_dict):
    """(model, params, folded params): the port's tree of ``state_dict``."""
    model = build(CFG)
    params = model.load(state_dict)
    return model, params, model.fold(params)


@pytest.fixture(scope="module")
def jax_tree(state_dict):
    return jax.tree.map(jnp.asarray, params_to_jax(state_dict))


def _ref(tiny, frames):
    """The port's straight forward of the folded tree on ``frames``."""
    model, _, folded = tiny
    with torch.no_grad():
        return model.apply(folded, torch.from_numpy(np.stack(frames))).numpy()


def _server(tiny, **kw):
    model, params, _ = tiny
    kw.setdefault("image_size", (HW, HW))
    return InferenceServer(model, params, device="cpu", **kw)


def _frames(rng, n, dtype=np.float32):
    if dtype == np.uint8:
        return [(rng.rand(HW, HW, 3) * 255).astype(np.uint8) for _ in range(n)]
    return [rng.rand(HW, HW, 3).astype(np.float32) for _ in range(n)]


def _start(target, *args, **kwargs):
    t = threading.Thread(target=target, args=args, kwargs=kwargs, daemon=True)
    t.start()
    return t


def _join(t, timeout=JOIN_S):
    t.join(timeout=timeout)
    assert not t.is_alive(), f"thread {t.name} still running after {timeout} s"


def _live_socket(tmp_path, srv, serve=serve_unix_socket):
    """Start ``serve`` (either package's unix accept loop) on a thread;
    returns (sock_path, stop, t)."""
    sock = str(tmp_path / "fd.sock")
    stop = threading.Event()
    ready = threading.Event()
    t = _start(serve, srv, sock, ready=ready, stop=stop, log=_quiet)
    assert ready.wait(timeout=JOIN_S)
    return sock, stop, t


def _stop(stop, t):
    stop.set()
    _join(t)


def _conn_dropped(c) -> bool:
    """True iff the server ended this connection (EOF or reset)."""
    try:
        return c.recv(1) == b""
    except ConnectionResetError:
        return True


# ---- the JAX package's server cases, pointed at the port ----


def test_server_matches_direct_forward(rng, tiny):
    """Concurrent single-frame submits == the folded batch forward,
    regardless of how requests were packed into batches; on the CPU the
    kernels' plain versions run (no launch)."""
    frames = _frames(rng, 5)
    ref = _ref(tiny, frames)
    counts = (COUNTER["K1"], COUNTER["K4"])
    with _server(tiny, batch_size=4) as srv:
        futs = [srv.submit(f) for f in frames]
        preds = [f.result(timeout=RESULT_S) for f in futs]
    assert (COUNTER["K1"], COUNTER["K4"]) == counts
    for i, p in enumerate(preds):
        assert p.shape == (HW, HW, 1) and p.dtype == np.float32
        np.testing.assert_allclose(p, ref[i], atol=1e-5)


def test_server_pads_lone_request(rng, tiny):
    """One request rides a zero-padded batch and still matches."""
    frame = _frames(rng, 1)[0]
    with _server(tiny, batch_size=4) as srv:
        np.testing.assert_allclose(srv.submit(frame).result(timeout=RESULT_S),
                                   _ref(tiny, [frame])[0], atol=1e-5)


def test_server_rejects_wrong_shape(tiny):
    with _server(tiny, batch_size=2) as srv:
        with pytest.raises(ValueError, match="HWC"):
            srv.submit(np.zeros((HW, HW), np.float32))


def test_unix_socket_round_trip(rng, tiny, tmp_path):
    """Full client/server protocol: length-prefixed npy frames over a
    unix socket, many requests per connection."""
    frames = _frames(rng, 3)
    ref = _ref(tiny, frames)
    with _server(tiny, batch_size=2) as srv:
        sock, stop, t = _live_socket(tmp_path, srv)
        for i, f in enumerate(frames):
            np.testing.assert_allclose(request(sock, f), ref[i], atol=1e-5)
        _stop(stop, t)
    assert not os.path.exists(sock)


def test_parse_address():
    assert parse_address("/tmp/fd.sock") == ("unix", "/tmp/fd.sock")
    assert parse_address("relative.sock") == ("unix", "relative.sock")
    assert parse_address("127.0.0.1:7000") == ("tcp", "127.0.0.1", 7000)
    assert parse_address("0.0.0.0:80") == ("tcp", "0.0.0.0", 80)
    assert parse_address("[::1]:7000") == ("tcp", "::1", 7000)
    # a path with a colon stays a unix path; a non-numeric port too
    assert parse_address("/tmp/a:b.sock") == ("unix", "/tmp/a:b.sock")
    assert parse_address("host:abc") == ("unix", "host:abc")
    # a BARE IPv6 address must not split inside itself ('::' port 1)
    assert parse_address("::1") == ("unix", "::1")
    assert parse_address("fe80::2:7000") == ("unix", "fe80::2:7000")


def _tcp_server(srv, host):
    stop, ready = threading.Event(), threading.Event()
    t = _start(serve_tcp, srv, host, 0, ready=ready, stop=stop, log=_quiet)
    return stop, ready, t


def test_tcp_round_trip_and_stream(rng, tiny):
    """Same protocol over TCP (serve_tcp, ephemeral port): single round
    trips AND the pipelined stream client, matching the folded forward."""
    frames = _frames(rng, 4)
    ref = _ref(tiny, frames)
    with _server(tiny, batch_size=2) as srv:
        stop, ready, t = _tcp_server(srv, "127.0.0.1")
        assert ready.wait(timeout=JOIN_S)
        spec = "%s:%d" % srv.bound_address
        np.testing.assert_allclose(request(spec, frames[0]), ref[0], atol=1e-5)
        for i, p in enumerate(request_stream(spec, frames, depth=4)):
            np.testing.assert_allclose(p, ref[i], atol=1e-5)
        _stop(stop, t)


def test_tcp_ipv6_round_trip(rng, tiny):
    """serve_tcp resolves the address family from the host: [::1]:port
    round-trips."""
    frame = _frames(rng, 1)[0]
    with _server(tiny, batch_size=2) as srv:
        stop, ready, t = _tcp_server(srv, "::1")
        if not ready.wait(timeout=JOIN_S):
            pytest.skip("IPv6 loopback unavailable on this host")
        np.testing.assert_allclose(request("[::1]:%d" % srv.bound_address[1], frame),
                                   _ref(tiny, [frame])[0], atol=1e-5)
        _stop(stop, t)


def test_serve_cli_refusal_leaves_live_socket_intact(rng, tiny, tmp_path):
    """A second daemon refused at startup (a live daemon owns the unix
    socket) must NOT unlink the live daemon's socket file."""
    with _server(tiny, batch_size=2) as srv:
        sock, stop, t = _live_socket(tmp_path, srv)
        with pytest.raises(RuntimeError, match="live server"):
            serve_unix_socket(srv, sock, log=_quiet)
        assert os.path.exists(sock)
        assert request(sock, _frames(rng, 1)[0]).shape == (HW, HW, 1)
        _stop(stop, t)


def test_serve_cli_ping(rng, tiny, tmp_path, capsys):
    """The CLI's client mode against a live server (CHW input accepted,
    NCHW prediction saved like the reference deploy runner)."""
    frame = _frames(rng, 1)[0]
    rgb_path = str(tmp_path / "rgb.npy")
    np.save(rgb_path, np.transpose(frame, (2, 0, 1)))  # CHW like deploy data
    out_path = str(tmp_path / "pred.npy")
    with _server(tiny, batch_size=2) as srv:
        sock, stop, t = _live_socket(tmp_path, srv)
        rc = serve_cli.main(["--socket", sock, "--ping", rgb_path, "--ping-out", out_path])
        _stop(stop, t)
    assert rc == 0
    assert "pred shape=(64, 64, 1)" in capsys.readouterr().out
    saved = np.load(out_path)
    assert saved.shape == (1, 1, HW, HW)
    np.testing.assert_allclose(saved[0, 0], _ref(tiny, [frame])[0, :, :, 0], atol=1e-5)


def test_serve_cli_stream_ping(rng, tiny, tmp_path, capsys):
    """--ping --stream N drives the pipelined client through the CLI."""
    rgb_path = str(tmp_path / "rgb.npy")
    np.save(rgb_path, _frames(rng, 1)[0])
    with _server(tiny, batch_size=4) as srv:
        sock, stop, t = _live_socket(tmp_path, srv)
        rc = serve_cli.main(["--socket", sock, "--ping", rgb_path,
                             "--stream", "9", "--stream-depth", "8"])
        _stop(stop, t)
    assert rc == 0
    assert "streamed 9 frames" in capsys.readouterr().out
    assert srv.stats()["frames"] == 9


def test_serve_cli_stats_client(rng, tiny, tmp_path, capsys):
    """'cli.serve --stats' fetches the live health/stats JSON over the
    wire op."""
    with _server(tiny, batch_size=4) as srv:
        sock, stop, t = _live_socket(tmp_path, srv)
        srv.submit(_frames(rng, 1)[0]).result(timeout=RESULT_S)
        rc = serve_cli.main(["--socket", sock, "--stats"])
        _stop(stop, t)
    assert rc == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["status"] == "ok" and stats["frames"] == 1
    assert stats["latency_ms"]["count"] == 1


@pytest.fixture
def ckpt(state_dict, tmp_path):
    path = str(tmp_path / "tiny.npz")
    save_checkpoint(path, params_to_jax(state_dict), CFG)
    return path


def _daemon(argv):
    """serve_cli.main(argv) on a thread until it is ready; returns
    (stop, thread, result dict)."""
    ready, stop, rc = threading.Event(), threading.Event(), {}
    t = _start(lambda: rc.setdefault("rc", serve_cli.main(argv, _ready=ready, _stop=stop)))
    assert ready.wait(timeout=60), "daemon never came up"
    return stop, t, rc


def test_serve_cli_daemon_launch_spatial_mesh(ckpt, tiny, rng, tmp_path):
    """The JAX CLI's spatial mesh daemon launch on the port, at two ranks
    (data=1, space=2: two gloo ranks spawned on the CPU): rank 0 binds
    the socket and answers a client ping with the single-process
    prediction (atol 1e-5, the JAX test's); ``_stop`` reaches rank 0 as a
    SIGINT and the daemon exits 0.  A spawned rank cannot set this
    process's ``_ready``, so the test waits for the socket file."""
    sock = str(tmp_path / "fd.sock")
    stop, rc = threading.Event(), {}
    t = _start(lambda: rc.setdefault("rc", serve_cli.main(
        ["--evaluate", ckpt, "--socket", sock, "--batch-size", "2", "--image-size", str(HW),
         str(HW), "--stats-every", "0", "--mesh-devices", "1", "--mesh-spatial", "2",
         "--device", "cpu"], _stop=stop)))
    deadline = time.monotonic() + RESULT_S
    while not os.path.exists(sock) and time.monotonic() < deadline and t.is_alive():
        time.sleep(0.05)
    assert os.path.exists(sock), "daemon never bound its socket"
    frame = _frames(rng, 1)[0]
    pred = request(sock, frame)
    _stop(stop, t)
    assert rc.get("rc") == 0
    np.testing.assert_allclose(pred, _ref(tiny, [frame])[0], atol=1e-5)


@pytest.mark.parametrize("flags, item", [
    (["--mesh-devices", "3"], "--batch-size 32 must divide by --mesh-devices 3"),
    (["--mesh-spatial", "5"], "--mesh-spatial 5 must divide the 224-row image height"),
    (["--impl", "mixed"], "needs a tuning record"),
    (["--impl", "mixed", "--tuning", "tuning/h100.json"], "no tuning record at"),
])
def test_serve_cli_refuses_unported_flags(flags, item, ckpt, tmp_path):
    with pytest.raises(SystemExit, match=item):
        serve_cli.main(["--evaluate", ckpt, "--socket", str(tmp_path / "fd.sock"),
                        "--device", "cpu", *flags])


@pytest.mark.parametrize("transport", ["unix", "tcp"])
def test_serve_cli_daemon_launch(transport, rng, tiny, ckpt, tmp_path):
    """The CLI's daemon-launch path end to end on the CPU: load an .npz
    checkpoint, serve over a unix socket or --socket 127.0.0.1:PORT
    (serve_tcp), answer a client ping with the folded forward."""
    if transport == "tcp":
        probe = socket.socket()
        probe.bind(("127.0.0.1", 0))
        spec = "127.0.0.1:%d" % probe.getsockname()[1]
        probe.close()
    else:
        spec = str(tmp_path / "fd.sock")
    stop, t, rc = _daemon(["--evaluate", ckpt, "--socket", spec, "--batch-size", "2",
                           "--image-size", str(HW), str(HW), "--stats-every", "0",
                           "--device", "cpu"])
    frame = _frames(rng, 1)[0]
    pred = request(spec, frame)
    stop.set()
    _join(t, 30)
    assert rc.get("rc") == 0
    np.testing.assert_allclose(pred, _ref(tiny, [frame])[0], atol=1e-5)


def test_stream_half_close_survives_slow_first_result(rng, tiny, tmp_path, monkeypatch):
    """A pipelined client half-closes after its last frame while the
    first result is still pending: the handler's drain must wait on
    device work (only a send with zero progress means a dead peer)."""
    monkeypatch.setattr(srv_mod, "DRAIN_NO_PROGRESS_TIMEOUT", 0.2)
    frames = _frames(rng, 3)
    with _server(tiny, batch_size=2) as srv:
        real_submit = srv.submit

        def slow_submit(frame):
            inner = real_submit(frame)
            outer: Future = Future()

            def chain():
                time.sleep(1.0)  # >> the shrunk no-progress timeout
                try:
                    outer.set_result(inner.result(timeout=RESULT_S))
                except Exception as e:  # pragma: no cover
                    outer.set_exception(e)

            _start(chain)
            return outer

        srv.submit = slow_submit
        sock, stop, t = _live_socket(tmp_path, srv)
        preds = list(request_stream(sock, frames, depth=4))
        _stop(stop, t)
    assert len(preds) == 3
    ref = _ref(tiny, frames)
    for i, p in enumerate(preds):
        np.testing.assert_allclose(p, ref[i], atol=1e-5)


def test_server_uint8_device_normalize(rng, tiny):
    """uint8 ingestion == the float path on the same /255'd frames."""
    raw = _frames(rng, 1, np.uint8)[0]
    ref = _ref(tiny, [raw.astype(np.float32) / 255.0])[0]
    with _server(tiny, batch_size=2, input_dtype=np.uint8) as srv:
        np.testing.assert_allclose(srv.submit(raw).result(timeout=RESULT_S), ref, atol=1e-5)
        with pytest.raises(ValueError, match="input_dtype"):
            srv.submit(raw.astype(np.float32))


def test_server_pipelined_burst(rng, tiny):
    """A deep burst (many batches in flight) resolves every future
    correctly with the pipelined drainer."""
    frames = _frames(rng, 33)
    ref = _ref(tiny, frames)
    with _server(tiny, batch_size=8, pipeline_depth=3) as srv:
        futs = [srv.submit(f) for f in frames]
        for i, f in enumerate(futs):
            np.testing.assert_allclose(f.result(timeout=RESULT_S), ref[i], atol=1e-5)


def test_server_stats_counters(rng, tiny):
    with _server(tiny, batch_size=4) as srv:
        futs = [srv.submit(f) for f in _frames(rng, 6)]
        for f in futs:
            f.result(timeout=RESULT_S)
        s = srv.stats()
    assert s["frames"] == 6
    assert s["batches"] >= 2  # 6 frames through batch-4 packing
    assert 0 < s["mean_occupancy"] <= 1.0


def test_server_chain_mode_matches_direct_forward(rng, tiny):
    """Chain mode: each window runs as sequential batch-1 forwards —
    results equal the straight forward, padding and packing included."""
    frames = _frames(rng, 5)
    ref = _ref(tiny, frames)
    with _server(tiny, batch_size=4, chain=True) as srv:
        futs = [srv.submit(f) for f in frames]
        preds = [f.result(timeout=RESULT_S) for f in futs]
        assert srv.stats()["chain"] is True
    for i, p in enumerate(preds):
        np.testing.assert_allclose(p, ref[i], atol=1e-5)


class _MeshShape:
    """A mesh as the server's checks read it (its axis sizes and device):
    they run before the server touches the process group."""

    def __init__(self, **shape):
        self.shape = shape
        self.device = torch.device("cpu")


@pytest.mark.parametrize("kw, message", [
    # chain over a data mesh
    ({"batch_size": 4, "chain": True, "mesh": _MeshShape(data=2)},
     "a 'data' mesh axis would shard the scan axis"),
    # batch 6 over an 8-device data mesh
    ({"batch_size": 6, "mesh": _MeshShape(data=8)},
     "batch_size 6 must divide by the mesh's 8-way 'data' axis"),
    # a (data=2, space=4) mesh: the height must divide by the space axis
    ({"batch_size": 2, "image_size": (HW + 2, HW), "mesh": _MeshShape(data=2, space=4)},
     f"image height {HW + 2} must divide by the mesh's 4-way 'space' axis"),
], ids=["chain_rejects_data_mesh", "mesh_sharded", "mesh_spatial"])
def test_server_mesh_is_refused(kw, message, tiny):
    """The JAX server's three mesh validations, with its messages, before
    the server prepares anything (the mesh servers' answers:
    ``tests/test_torch_spatial.py``)."""
    with pytest.raises(ValueError, match=message):
        _server(tiny, **kw)


# the tuned dispatch's winner map: K1's plain version on levels 1, 3 and 5
MIXED = {1: "pallas", 2: "xla", 3: "pallas", 4: "xla", 5: "pallas"}


@pytest.mark.parametrize("kw", [{"impl": "mixed"}, {"tuning": "tuning/h100.json"}])
def test_server_tuned_dispatch_is_refused(kw, rng, tiny, jax_tree, tmp_path):
    """Half of the tuned dispatch's pair is refused: impl='mixed' without
    a record, a record without impl='mixed'.  The whole pair serves the
    JAX server's answers for the same winners, numpy tree and frames
    (1e-5): from a record file after the first half, from a winner map
    after the second."""
    with pytest.raises(ValueError, match="needs a tuning record" if "impl" in kw
                       else "applies to impl='mixed' only"):
        _server(tiny, batch_size=2, **kw)
    tuning = MIXED
    if "impl" in kw:
        tuning = str(tmp_path / "rec.json")
        with open(tuning, "w") as f:
            json.dump({"config": {}, "device": "x", "records": [
                {"stage": s, "dtype": d, "winner": w} for s, w in MIXED.items()
                for d in ("float32", "bfloat16")]}, f)
    frames = _frames(rng, 3)
    with JS.InferenceServer(jax_build(to_jax(CFG)), jax_tree, batch_size=2,
                            image_size=(HW, HW), impl="mixed", tuning=tuning) as js:
        want = np.stack([f.result(timeout=RESULT_S) for f in [js.submit(x) for x in frames]])
    with _server(tiny, batch_size=2, impl="mixed", tuning=tuning) as srv:
        got = np.stack([f.result(timeout=RESULT_S) for f in [srv.submit(x) for x in frames]])
    assert got.shape == want.shape == (3, HW, HW, 1) and got.std() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_server_latency_distribution(rng, tiny):
    """stats()['latency_ms'] tracks submit->resolved per request: count
    matches, p50 <= p99 <= max, all positive."""
    with _server(tiny, batch_size=4) as srv:
        futs = [srv.submit(f) for f in _frames(rng, 9)]
        for f in futs:
            f.result(timeout=RESULT_S)
        s = srv.stats()
    lat = s["latency_ms"]
    assert lat["count"] == 9
    assert 0 < lat["p50"] <= lat["p99"] <= lat["max"]
    assert s["status"] == "ok" and s["uptime_s"] >= 0


def test_socket_stats_op(rng, tiny, tmp_path):
    """The wire protocol's zero-length health/stats op: the live stats
    JSON (latency percentiles included) between predictions."""
    frame = _frames(rng, 1)[0]
    with _server(tiny, batch_size=2) as srv:
        sock, stop, t = _live_socket(tmp_path, srv)
        s0 = request_stats(sock)
        assert s0["status"] == "ok" and s0["frames"] == 0
        assert "latency_ms" not in s0
        np.testing.assert_allclose(request(sock, frame), _ref(tiny, [frame])[0], atol=1e-5)
        s1 = request_stats(sock)
        assert s1["frames"] == 1
        assert s1["latency_ms"]["count"] == 1
        assert s1["latency_ms"]["p99"] > 0
        json.dumps(s1)  # the whole payload stays JSON-round-trippable
        _stop(stop, t)


def test_server_float16_output(rng, tiny):
    """output_dtype=float16 halves the payload; values match f32 within
    f16 precision."""
    frame = _frames(rng, 1)[0]
    with _server(tiny, batch_size=2, output_dtype=np.float16) as srv:
        pred = srv.submit(frame).result(timeout=RESULT_S)
    assert pred.dtype == np.float16
    np.testing.assert_allclose(pred.astype(np.float32), _ref(tiny, [frame])[0], atol=2e-3)


def test_server_survives_cancelled_futures(rng, tiny):
    """A future cancelled before resolution must not kill the drainer."""
    frames = _frames(rng, 4)
    with _server(tiny, batch_size=2) as srv:
        futs = [srv.submit(f) for f in frames]
        futs[1].cancel()  # may or may not land before the drainer claims it
        done = [f.result(timeout=RESULT_S) for f in futs if not f.cancelled()]
        assert len(done) in (3, 4)
        assert srv.submit(frames[0]).result(timeout=RESULT_S).shape == (HW, HW, 1)


def test_server_submit_after_close_raises(tiny):
    srv = _server(tiny, batch_size=2)
    srv.close()
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(np.zeros((HW, HW, 3), np.float32))


def test_server_result_owns_its_buffer(rng, tiny):
    """Predictions are copies, not views of the reused host buffer."""
    with _server(tiny, batch_size=4) as srv:
        pred = srv.submit(_frames(rng, 1)[0]).result(timeout=RESULT_S)
    assert pred.base is None


def test_socket_refuses_live_hijack(tiny, tmp_path):
    """A second daemon must refuse a socket path a live server owns."""
    with _server(tiny, batch_size=2) as srv:
        sock, stop, t = _live_socket(tmp_path, srv)
        with pytest.raises(RuntimeError, match="live server"):
            serve_unix_socket(srv, sock, log=_quiet)
        _stop(stop, t)


def _client(sock):
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.settimeout(JOIN_S)
    c.connect(sock)
    return c


def test_socket_rejects_oversized_length_header(rng, tiny, tmp_path):
    """A 4-byte header claiming a multi-GB payload gets the connection
    dropped (MAX_PAYLOAD), and the daemon keeps serving."""
    with _server(tiny, batch_size=2) as srv:
        sock, stop, t = _live_socket(tmp_path, srv)
        c = _client(sock)
        c.sendall((0xFFFFFFFF).to_bytes(4, "big") + b"\x93NUMPY junk")
        assert _conn_dropped(c)
        c.close()
        assert request(sock, _frames(rng, 1)[0]).shape == (HW, HW, 1)
        _stop(stop, t)


def test_socket_rejects_garbage_payload(rng, tiny, tmp_path):
    """A well-framed but non-npy body (or a pickle) is refused, and the
    daemon survives."""
    with _server(tiny, batch_size=2) as srv:
        sock, stop, t = _live_socket(tmp_path, srv)
        obj = io.BytesIO()
        np.save(obj, np.array([{"x": 1}], dtype=object), allow_pickle=True)
        for body in (b"this is not an npy payload at all", obj.getvalue(),
                     pickle.dumps({"boom": 1})):
            c = _client(sock)
            c.sendall(len(body).to_bytes(4, "big") + body)
            assert _conn_dropped(c)
            c.close()
        assert request(sock, _frames(rng, 1)[0]).shape == (HW, HW, 1)
        _stop(stop, t)


def test_socket_survives_client_disconnects(rng, tiny, tmp_path):
    """Torn streams both ways (a client that dies mid-request, and ones
    that die before reading their response) leave the daemon healthy."""
    frame = _frames(rng, 1)[0]
    with _server(tiny, batch_size=2) as srv:
        sock, stop, t = _live_socket(tmp_path, srv)
        c = _client(sock)
        c.sendall((10240).to_bytes(4, "big") + b"\x00" * 100)
        c.close()
        buf = io.BytesIO()
        np.save(buf, frame)
        payload = buf.getvalue()
        for _ in range(3):
            c = _client(sock)
            c.sendall(len(payload).to_bytes(4, "big") + payload)
            c.shutdown(socket.SHUT_RDWR)
            c.close()
        np.testing.assert_allclose(request(sock, frame), _ref(tiny, [frame])[0], atol=1e-5)
        _stop(stop, t)


def test_socket_pipelined_stream(rng, tiny, tmp_path):
    """request_stream keeps many requests in flight on ONE connection and
    receives every prediction in order; packing beats one at a time."""
    frames = _frames(rng, 21)
    ref = _ref(tiny, frames)
    with _server(tiny, batch_size=4) as srv:
        sock, stop, t = _live_socket(tmp_path, srv)
        preds = list(request_stream(sock, frames, depth=16))
        assert len(preds) == 21
        for i, p in enumerate(preds):
            np.testing.assert_allclose(p, ref[i], atol=1e-5, err_msg=str(i))
        stats = srv.stats()
        assert stats["frames"] == 21
        assert stats["mean_occupancy"] > 0.3, stats
        _stop(stop, t)


def test_socket_stream_survives_bad_middle_frame(rng, tiny, tmp_path):
    """A wrong-shape frame mid-stream kills only that connection; a fresh
    stream still works."""
    good = _frames(rng, 3)
    bad_mix = [good[0], rng.rand(8, 8, 3).astype(np.float32), good[1]]
    with _server(tiny, batch_size=2) as srv:
        sock, stop, t = _live_socket(tmp_path, srv)
        with pytest.raises((ConnectionError, BrokenPipeError, OSError)):
            list(request_stream(sock, bad_mix, depth=4))
        assert len(list(request_stream(sock, good, depth=4))) == 3
        _stop(stop, t)


def test_request_stream_no_hang_on_server_eof(rng, tmp_path):
    """A server that answers two frames then closes cleanly makes
    request_stream raise — with frames >> depth the sender sits in the
    window acquire and must see the reader's end.  The stream runs on a
    thread with a bounded join, so a hang fails instead of stalling."""
    sock_path = str(tmp_path / "eof.sock")
    lsock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    lsock.bind(sock_path)
    lsock.listen(1)
    lsock.settimeout(RESULT_S)

    def fake_server():
        try:
            conn, _ = lsock.accept()
            with conn:
                for _ in range(2):
                    arr = srv_mod._recv_npy(conn)
                    srv_mod._send_npy(conn, arr[..., :1])
        finally:
            lsock.close()

    server = _start(fake_server)
    frames = [rng.rand(4, 4, 3).astype(np.float32) for _ in range(40)]
    outcome = {}

    def consume():
        try:
            outcome["got"] = len(list(request_stream(sock_path, frames, depth=4)))
        except Exception as e:
            outcome["error"] = e

    _join(_start(consume), RESULT_S)
    _join(server)
    assert "got" not in outcome, "the stream ended as if every frame was answered"
    assert isinstance(outcome["error"], (ConnectionError, BrokenPipeError, OSError))


def test_request_stream_raises_when_the_sender_quits_early(rng, tmp_path):
    """The truncation the EOF test can only catch by chance, made certain:
    the frames' generator holds the sender after its 2nd frame until the
    fake server has answered both and closed, and until the stream's
    reader has seen that EOF (the ``dead`` flag of the sender's closure,
    read off the frame that asks for frame 3).  The sender then quits
    with 38 frames unsent and 2 of 2 sent answered: ``request_stream``
    must raise ``ConnectionError``, not end as a 2-answer stream."""
    sock_path = str(tmp_path / "short.sock")
    lsock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    lsock.bind(sock_path)
    lsock.listen(1)
    lsock.settimeout(RESULT_S)
    closed = threading.Event()

    def fake_server():
        try:
            conn, _ = lsock.accept()
            with conn:
                for _ in range(2):
                    srv_mod._send_npy(conn, srv_mod._recv_npy(conn)[..., :1])
        finally:
            lsock.close()
            closed.set()

    def frames():
        for _ in range(2):
            yield rng.rand(4, 4, 3).astype(np.float32)
        assert closed.wait(RESULT_S)
        assert sys._getframe(1).f_locals["dead"].wait(RESULT_S)
        for _ in range(38):
            yield rng.rand(4, 4, 3).astype(np.float32)

    server = _start(fake_server)
    outcome = {}

    def consume():
        try:
            outcome["got"] = len(list(request_stream(sock_path, frames(), depth=4)))
        except Exception as e:
            outcome["error"] = e

    _join(_start(consume), RESULT_S)
    _join(server)
    assert "got" not in outcome, f"the stream ended after {outcome.get('got')} of 40 frames"
    assert isinstance(outcome["error"], ConnectionError), outcome["error"]
    assert "2/2 answered, frames left unsent" in str(outcome["error"])


def test_resolve_future_idempotent():
    """The first resolution sticks, a late second resolver is a no-op,
    and a cancelled future stays cancelled."""
    f = Future()
    _resolve_future(f, value=1)
    _resolve_future(f, exc=RuntimeError("late loser"))  # must not raise
    assert f.result(timeout=1) == 1
    f2 = Future()
    f2.cancel()
    _resolve_future(f2, value=2)
    assert f2.cancelled()


def test_submit_vs_close_race_never_leaves_future_unresolved(rng, tiny):
    """close() landing between submit()'s closed-check and its queue put:
    the future still resolves (a result or 'server is closed')."""
    srv = _server(tiny, batch_size=2)
    orig_put = srv._q.put

    def racing_put(item, *a, **kw):
        srv._stop.set()  # simulate close() winning the race post-check
        orig_put(item, *a, **kw)

    srv._q.put = racing_put
    fut = srv.submit(_frames(rng, 1)[0])
    srv._q.put = orig_put
    done, _ = wait([fut], timeout=JOIN_S)
    assert fut in done, "future left unresolved by the submit/close race"
    if fut.exception() is not None:
        assert "closed" in str(fut.exception())
    srv.close()


def test_close_does_not_deadlock_on_full_queue(rng, tiny):
    """close() on a FULL queue: the drainer exits on the stop flag without
    consuming a sentinel, and every orphan is failed."""
    srv = _server(tiny, batch_size=2, max_queue=4)
    srv._stop.set()
    _join(srv._thread)
    srv._stop.clear()
    futs = []
    frame = _frames(rng, 1)[0]
    for _ in range(4):  # == max_queue
        fut = Future()
        srv._q.put((frame, fut, 0.0))
        futs.append(fut)
    _join(_start(srv.close))
    for fut in futs:
        assert fut.done() and "closed" in str(fut.exception())


def test_submit_copies_caller_buffer(rng, tiny):
    """The queued frame is the server's own copy unless copy_inputs=False."""
    buf = _frames(rng, 1)[0]
    for copy_inputs in (True, False):
        srv = _server(tiny, batch_size=2, copy_inputs=copy_inputs)
        srv._stop.set()  # park the drainer: the queue entry stays observable
        _join(srv._thread)
        srv._stop.clear()
        srv.submit(buf)
        queued, _, _ = srv._q.get_nowait()
        if copy_inputs:
            assert queued is not buf and not np.shares_memory(queued, buf)
            np.testing.assert_array_equal(queued, buf)
        else:
            assert queued is buf
        srv._stop.set()


def test_socket_stop_unblocks_live_connections(tiny, tmp_path):
    """The stop event ends LIVE connections, not just the accept loop."""
    with _server(tiny, batch_size=2) as srv:
        sock, stop, t = _live_socket(tmp_path, srv)
        conn = _client(sock)  # idle connection, reader parked in recv
        time.sleep(0.3)
        _stop(stop, t)
        assert conn.recv(1) == b""
        conn.close()


def test_close_is_fast_when_drainer_idle(tiny):
    """close() does not wait out its close_timeout when the drainer holds
    no in-flight work."""
    srv = _server(tiny, batch_size=2, close_timeout=600.0)
    srv.submit(np.zeros((HW, HW, 3), np.float32)).result(timeout=RESULT_S)
    t0 = time.perf_counter()
    srv.close()
    assert time.perf_counter() - t0 < 15.0
    assert not srv._thread.is_alive()


def test_close_resolves_every_queued_future(tiny):
    """Work the drainer already claimed finishes serving; anything still
    queued is failed ('server is closed'); nothing is left unresolved."""
    srv = _server(tiny, batch_size=2, close_timeout=120.0)
    srv.submit(np.zeros((HW, HW, 3), np.float32)).result(timeout=RESULT_S)
    futs = [srv.submit(np.zeros((HW, HW, 3), np.float32)) for _ in range(6)]
    srv.close()
    assert all(f.done() for f in futs)
    assert sum(1 for f in futs if f.exception() is None) >= 1
    for f in futs:
        if f.exception() is not None:
            assert "closed" in str(f.exception())


# ---- the port against the JAX package ----


MODES = {
    "f32": {},
    "uint8_in": {"input_dtype": np.uint8},
    "f16_out": {"output_dtype": np.float16},
    "chain": {"chain": True},
}


@pytest.mark.parametrize("mode", list(MODES))
def test_server_matches_the_jax_server(mode, rng, tiny, jax_tree):
    """The same numpy tree and frames through both packages' servers (at
    batch 4, 5 frames: a padded tail): f32 within 1e-4; f16 out within
    one f16 step of the JAX server's at each value."""
    kw = MODES[mode]
    frames = _frames(rng, 5, kw.get("input_dtype", np.float32))
    with JS.InferenceServer(jax_build(to_jax(CFG)), jax_tree, batch_size=4,
                            image_size=(HW, HW), **kw) as js:
        want = np.stack([f.result(timeout=RESULT_S) for f in [js.submit(x) for x in frames]])
    with _server(tiny, batch_size=4, **kw) as srv:
        got = np.stack([f.result(timeout=RESULT_S) for f in [srv.submit(x) for x in frames]])
    assert got.dtype == want.dtype and got.shape == want.shape == (5, HW, HW, 1)
    got, want = got.astype(np.float32), want.astype(np.float32)
    if mode == "f16_out":
        step = np.spacing(np.abs(want).astype(np.float16)).astype(np.float32)
        assert np.all(np.abs(got - want) <= step + 1e-4), float(np.abs(got - want).max())
    else:
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_bf16_server_matches_the_bf16_forward(rng, tiny):
    """A bf16 server against the port's bf16 forward called directly on
    the same frames (both fold in f32, then cast), to 2^-7 max|ref|."""
    model, params, _ = tiny
    frames = _frames(rng, 4)
    p, apply = _prepare(model, params, batch_size=4, dtype=torch.bfloat16, fold_bn=True,
                        impl="auto", device="cpu")
    with torch.no_grad():
        want = apply(p, torch.from_numpy(np.stack(frames)).to(torch.bfloat16)).float().numpy()
    with _server(tiny, batch_size=4, dtype=torch.bfloat16) as srv:
        got = np.stack([f.result(timeout=RESULT_S) for f in [srv.submit(x) for x in frames]])
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2 ** -7 * float(np.abs(want).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_normalize_divides_in_the_compute_dtype(dtype):
    """uint8 -> [0, 1]: cast, then divide in the compute dtype, bit for
    bit as numpy's host path divides (f32; bf16: the f32 quotient of the
    cast, rounded) and as JAX's cast-then-divide op by op.  (The JAX
    server's jitted forward multiplies by the reciprocal instead: 126 of
    the 256 f32 values 1 ulp off.)"""
    raw = np.arange(256, dtype=np.uint8)
    got = normalize(torch.from_numpy(raw), getattr(torch, dtype)).float().numpy()
    if dtype == "float32":
        host = raw.astype(np.float32) / np.float32(255)
    else:
        bf16 = ml_dtypes.bfloat16
        host = (raw.astype(bf16).astype(np.float32) / np.float32(255)).astype(bf16)
    np.testing.assert_array_equal(got, np.asarray(host, np.float32))
    jdt = getattr(jnp, dtype)
    eager = (jnp.asarray(raw).astype(jdt) / 255.0).astype(jnp.float32)
    np.testing.assert_array_equal(got, np.asarray(eager))


def test_jax_clients_talk_to_the_port_server(rng, tiny, tmp_path):
    """The JAX package's request / request_stream / request_stats against
    the port's unix daemon."""
    frames = _frames(rng, 5)
    ref = _ref(tiny, frames)
    with _server(tiny, batch_size=2) as srv:
        sock, stop, t = _live_socket(tmp_path, srv)
        assert JS.request_stats(sock)["frames"] == 0
        np.testing.assert_allclose(JS.request(sock, frames[0]), ref[0], atol=1e-5)
        preds = list(JS.request_stream(sock, frames, depth=4))
        stats = JS.request_stats(sock)
        _stop(stop, t)
    assert len(preds) == 5
    for i, p in enumerate(preds):
        np.testing.assert_allclose(p, ref[i], atol=1e-5)
    assert stats["frames"] == 6 and stats["latency_ms"]["count"] == 6


def test_port_clients_talk_to_the_jax_server(rng, tiny, jax_tree, tmp_path):
    """The port's request / request_stream / request_stats against the JAX
    package's unix daemon (its serve_unix_socket)."""
    frames = _frames(rng, 5)
    ref = _ref(tiny, frames)
    with JS.InferenceServer(jax_build(to_jax(CFG)), jax_tree, batch_size=2,
                            image_size=(HW, HW)) as js:
        sock, stop, t = _live_socket(tmp_path, js, serve=JS.serve_unix_socket)
        assert request_stats(sock)["frames"] == 0
        np.testing.assert_allclose(request(sock, frames[0]), ref[0], atol=1e-4)
        preds = list(request_stream(sock, frames, depth=4))
        stats = request_stats(sock)
        _stop(stop, t)
    assert len(preds) == 5
    for i, p in enumerate(preds):
        np.testing.assert_allclose(p, ref[i], atol=1e-4)
    assert stats["frames"] == 6 and stats["latency_ms"]["count"] == 6


class _Wire:
    """A connection that records what is sent and replays it on recv."""

    def __init__(self, data=b""):
        self.sent = b""
        self.data = data

    def sendall(self, b):
        self.sent += b

    def recv(self, n):
        out, self.data = self.data[:n], self.data[n:]
        return out


@pytest.mark.parametrize("arr", [
    np.arange(12, dtype=np.float32).reshape(2, 2, 3),
    np.arange(12, dtype=np.uint8).reshape(2, 2, 3),
    np.linspace(0, 10, 4, dtype=np.float16).reshape(2, 2, 1),
], ids=["f32", "uint8", "f16"])
def test_wire_frames_equal_the_jax_package_byte_for_byte(arr):
    """Both packages frame an array into the same bytes and read each
    other's frames back; a zero-length frame is the stats op in both."""
    mine, theirs = _Wire(), _Wire()
    srv_mod._send_npy(mine, arr)
    JS._send_npy(theirs, arr)
    assert mine.sent == theirs.sent
    np.testing.assert_array_equal(srv_mod._recv_npy(_Wire(theirs.sent)), arr)
    np.testing.assert_array_equal(JS._recv_npy(_Wire(mine.sent)), arr)
    assert srv_mod._recv_npy(_Wire(bytes(4))) is srv_mod.STATS_REQUEST
    assert srv_mod.MAX_PAYLOAD == JS.MAX_PAYLOAD
    with pytest.raises(srv_mod.ProtocolError):
        srv_mod._recv_npy(_Wire((srv_mod.MAX_PAYLOAD + 1).to_bytes(4, "big")))


# ---- the card by default ----


def test_server_and_cli_default_to_the_card(tiny, ckpt, tmp_path):
    """Without device= / --device the server and the CLI ask for the card,
    and refuse to start without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks the refusal without one")
    model, params, _ = tiny
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceServer(model, params, batch_size=2, image_size=(HW, HW))
    assert serve_cli.parse_args([]).device == "cuda"
    with pytest.raises(SystemExit, match="no CUDA device"):
        serve_cli.main(["--evaluate", ckpt, "--socket", str(tmp_path / "fd.sock")])
    assert not os.path.exists(tmp_path / "fd.sock")
