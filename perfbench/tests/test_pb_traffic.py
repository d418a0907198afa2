"""The open-loop schedule, and a whole exchange between the client
process and the port's ``serve_unix_socket`` over a tiny model on the
CPU."""

from __future__ import annotations

import numpy as np
import pytest

from perfbench.traffic import schedule, wire


@pytest.mark.parametrize("rate,seconds,conns", [(800.0, 10.0, 4), (37.0, 3.0, 1)])
def test_schedule_offers_the_rate(rate, seconds, conns):
    due = schedule.due_times(rate, seconds, 2 ** 31 + 3, 20, conns)
    assert len(due) == conns
    n = int(round(rate / conns * seconds))
    for d in due:
        assert len(d) == n and np.all(np.diff(d) >= 0) and 0 < d[0]
        assert d[-1] == pytest.approx(seconds)
    assert sum(len(d) for d in due) / seconds == pytest.approx(rate, rel=0.02)


def test_schedule_is_seeded_and_keeps_its_gaps_across_seeds():
    a = schedule.due_times(500, 5, 11, 20, 4)
    b = schedule.due_times(500, 5, 11, 20, 4)
    c = schedule.due_times(500, 5, 12, 20, 4)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    for x, y in zip(a, c):  # the same gaps in another order
        gx, gy = np.diff(x, prepend=0), np.diff(y, prepend=0)
        assert np.allclose(np.sort(gx), np.sort(gy))


def test_schedule_gaps_are_exponential():
    d = schedule.due_times(1000, 20, 5, 20, 1)[0]
    gaps = np.diff(d)
    assert np.std(gaps) / np.mean(gaps) == pytest.approx(1.0, abs=0.05)


def test_samples_hold_the_last_request():
    s = schedule.sampled(100, 8, 2 ** 31 + 1, 0)
    assert 99 in s and len(s) in (8, 9)


def test_wire_round_trip():
    arr = np.arange(24, dtype=np.float16).reshape(2, 3, 4)
    data = wire.encode(arr) + wire.encode(arr[:1])
    dec = wire.Decoder()
    got = dec.feed(data[:7]) + dec.feed(data[7:])
    assert len(got) == 2 and np.array_equal(got[0], arr) and np.array_equal(got[1], arr[:1])


def test_the_wire_copy_speaks_the_ports_protocol():
    import io

    from fastdepth_tpu_torch.engine import server

    arr = np.zeros((4, 4, 3), np.uint8)
    buf = io.BytesIO()

    class Conn:
        def sendall(self, b):
            buf.write(b)

    server._send_npy(Conn(), arr)
    assert buf.getvalue() == wire.encode(arr)


def test_a_whole_exchange_with_the_ports_socket_server(root):
    from perfbench import run

    r = run.measure("fastdepth.serve-socket", 2 ** 31 + 21, 1.0, False, root=root,
                    device="cpu", check_device=False)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] == 40
    assert set(r["metrics"]) == {"served_frames_per_s", "setup_s"}
    assert 0 < r["metrics"]["served_frames_per_s"]["value"] <= 40.0
    c = r["compared"]["answer_rel_l2_over_witness"]
    assert c["value"] < c["limit"]


def record(due, recv):
    due, recv = np.asarray(due, float), np.asarray(recv, float)
    return {"due": due, "recv": recv, "sent": due.copy()}


def test_a_sweep_window_flags_a_growing_backlog():
    from perfbench import sweep

    due = np.linspace(0.01, 1.0, 100)
    steady = sweep.window_row(record(due, due + 0.01), 100.0, 1.0, 33.0)
    assert steady["passes"] and not steady["backlog_grows"]
    assert steady["p95_ms"] == pytest.approx(10.0)
    assert steady["frames_per_s"] == 99.0  # the last answer lands after the window
    growing = sweep.window_row(record(due, due + 0.01 + 0.1 * due), 100.0, 1.0, 33.0)
    assert growing["backlog_grows"] and not growing["passes"]
    lost = record(due, np.where(np.arange(100) == 50, np.nan, due + 0.01))
    assert sweep.window_row(lost, 100.0, 1.0, 33.0)["backlog_grows"]


def test_the_sweep_finds_the_knee_and_the_capacity():
    from perfbench import sweep

    rows = [{"rate": r, "passes": ok, "frames_per_s": f} for r, ok, f in [
        (100.0, True, 99.0), (100.0, True, 99.5), (200.0, True, 198.0), (200.0, True, 199.0),
        (400.0, False, 390.0), (400.0, True, 395.0), (800.0, True, 700.0), (800.0, False, 720.0),
        (1600.0, False, 710.0), (1600.0, False, 705.0)]]
    s = sweep.summary(rows)
    assert s["knee_rps"] == 200.0  # 400 fails once; 800 passing once does not count
    assert s["capacity_frames_per_s"] == pytest.approx(710.0)
    assert s["capacity_at_rate"] == 800.0
    assert sweep.summary(rows[4:])["knee_rps"] is None
