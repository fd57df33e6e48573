"""Live sensor streaming: a framed binary protocol over pipes/sockets.

A copy of ``wildcat_slam_tpu/io/stream.py`` (numpy only; held equal to it by a
test), so that the port imports nothing of the JAX package.

The reference runs online off ROS subscribers (wildcat_slam_node.cc:69-79:
ros::spin over the IMU and lidar callbacks). The TPU-native equivalent keeps
the transport trivial and ROS-free: a producer writes framed IMU/scan messages
to a pipe, FIFO, or TCP socket; the CLI's ``--stream`` mode consumes them and
runs the odometry with per-sweep latency accounting (see cli.py).

Frame layout (little-endian):
    magic   4 bytes  b"WCST"
    type    u8       1 = IMU, 2 = SCAN, 3 = END
    length  u32      payload bytes
IMU payload:  7 x f64: t, acc[3], gyr[3]
SCAN payload: u32 n, f64 t0, then n records of 4 x f32: (t - t0), x, y, z
              (the lidar-frame point layout of the .wcs scan format,
              io/dataset.py)
END payload:  empty — producer is done; the consumer drains and exits.

Also provides ``stream_synthetic``, the demo producer used by
``python -m wildcat_slam_tpu_torch.io.stream``: generates a synthetic sequence and
emits it paced to the sensor clock (rate-multiplied), so a shell pipe
demonstrates genuinely live operation:

    python -m wildcat_slam_tpu_torch.io.stream --duration 8 --speed 1 | \\
        python -m wildcat_slam_tpu_torch.cli --stream - --verbose
"""

from __future__ import annotations

import struct
import time
from typing import BinaryIO, Iterator, Tuple

import numpy as np

MAGIC = b"WCST"
TYPE_IMU = 1
TYPE_SCAN = 2
TYPE_END = 3

_HDR = struct.Struct("<4sBI")
_IMU = struct.Struct("<7d")


def write_imu(f: BinaryIO, t: float, acc, gyr) -> None:
    payload = _IMU.pack(t, *np.asarray(acc, np.float64), *np.asarray(gyr, np.float64))
    f.write(_HDR.pack(MAGIC, TYPE_IMU, len(payload)))
    f.write(payload)


def write_scan(f: BinaryIO, times: np.ndarray, pts: np.ndarray) -> None:
    times = np.asarray(times, np.float64)
    pts = np.asarray(pts, np.float32)
    n = len(times)
    t0 = float(times[0]) if n else 0.0
    rec = np.empty((n, 4), np.float32)
    rec[:, 0] = (times - t0).astype(np.float32)
    rec[:, 1:4] = pts
    payload = struct.pack("<Id", n, t0) + rec.tobytes()
    f.write(_HDR.pack(MAGIC, TYPE_SCAN, len(payload)))
    f.write(payload)


def write_end(f: BinaryIO) -> None:
    f.write(_HDR.pack(MAGIC, TYPE_END, 0))


def _read_exact(f: BinaryIO, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = f.read(n - len(buf))
        if not chunk:
            raise EOFError(f"stream truncated: wanted {n} bytes, got {len(buf)}")
        buf += chunk
    return buf


def read_stream(f: BinaryIO) -> Iterator[Tuple]:
    """Yield ("imu", t, acc, gyr) and ("scan", times, pts) events until an END
    frame or EOF. Raises ValueError on a corrupt frame."""
    while True:
        try:
            hdr = _read_exact(f, _HDR.size)
        except EOFError:
            return
        magic, typ, length = _HDR.unpack(hdr)
        if magic != MAGIC:
            raise ValueError(f"bad stream magic {magic!r}")
        payload = _read_exact(f, length) if length else b""
        if typ == TYPE_END:
            return
        if typ == TYPE_IMU:
            vals = _IMU.unpack(payload)
            yield ("imu", vals[0], np.asarray(vals[1:4]), np.asarray(vals[4:7]))
        elif typ == TYPE_SCAN:
            n, t0 = struct.unpack_from("<Id", payload)
            rec = np.frombuffer(payload, np.float32, count=n * 4,
                                offset=struct.calcsize("<Id")).reshape(n, 4)
            times = t0 + rec[:, 0].astype(np.float64)
            yield ("scan", times, rec[:, 1:4].copy())
        else:
            raise ValueError(f"unknown frame type {typ}")


class BoundedQueueReader:
    """Explicit overload policy for live sources: bounded queues, drop-oldest.

    Over a pipe, ``read_stream`` exerts backpressure — the producer blocks when
    the pipe fills. That is correct for offline replay but wrong for a live
    sensor, which cannot pause the world; unbounded buffering on the producer
    side (or in the kernel socket buffer) just hides the overload. The
    reference bounds its ROS subscriber queues instead (imu 100000, lidar
    10000, wildcat_slam_node.cc:71-72; ROS drops the OLDEST message when a
    bounded queue overflows). This wrapper reproduces that policy: a reader
    thread drains the source at transport speed into per-type bounded deques;
    an enqueue onto a full deque evicts the oldest message of that type, and
    every eviction is counted in ``dropped`` — overload is never silent.

    Iteration yields events in producer order (a monotone sequence number is
    attached at enqueue and the two queue heads are merged by it), so the
    consumer sees the same interleave as ``read_stream`` minus the dropped
    messages — time-ordered streams stay time-ordered after drops.

    Default bounds: the IMU bound mirrors the reference's 100000 (a few MB).
    The scan bound is deliberately smaller than the reference's 10000 lidar
    queue — scans are ~100 KB-1 MB each, so 10000 would be gigabytes of
    hidden buffering; 512 scans is minutes of backlog, far past the point
    where dropping is the only sane answer.
    """

    def __init__(self, f: BinaryIO, imu_queue: int = 100000, scan_queue: int = 512):
        """A bound of 0 means a truly unbounded queue for that type (no
        drop-oldest eviction — memory grows with backlog). Producer
        backpressure exists only when the caller bypasses this wrapper
        entirely (cli.py takes plain ``read_stream`` when BOTH bounds are 0)."""
        import collections
        import threading

        self._queues = {"imu": collections.deque(), "scan": collections.deque()}
        self._bounds = {"imu": int(imu_queue), "scan": int(scan_queue)}
        self.dropped = {"imu": 0, "scan": 0}
        self._lock = threading.Lock()
        self._ready = threading.Event()
        self._done = False
        self._error = None
        self._thread = threading.Thread(target=self._drain, args=(f,), daemon=True)
        self._thread.start()

    def _drain(self, f: BinaryIO) -> None:
        seq = 0
        try:
            for ev in read_stream(f):
                kind = ev[0]
                with self._lock:
                    q = self._queues[kind]
                    if 0 < self._bounds[kind] <= len(q):
                        q.popleft()
                        self.dropped[kind] += 1
                    q.append((seq, ev))
                    seq += 1
                    self._ready.set()
        except BaseException as e:  # surfaced on the consumer side
            self._error = e
        finally:
            with self._lock:
                self._done = True
                self._ready.set()

    def __iter__(self) -> Iterator[Tuple]:
        while True:
            with self._lock:
                heads = [(q[0][0], k) for k, q in self._queues.items() if q]
                if heads:
                    _, kind = min(heads)
                    _, ev = self._queues[kind].popleft()
                elif self._done:
                    if self._error is not None:
                        raise self._error
                    return
                else:
                    ev = None
                    self._ready.clear()
            if ev is not None:
                yield ev
            else:
                self._ready.wait(timeout=1.0)

    def join(self, timeout: float | None = None) -> None:
        """Wait for the reader thread to finish draining the source (test aid:
        a joined reader iterates deterministically)."""
        self._thread.join(timeout)


def open_source(src: str) -> BinaryIO:
    """Resolve a --stream source: '-' = stdin, 'tcp:HOST:PORT' = connect,
    anything else = path (regular file or FIFO)."""
    import sys

    if src == "-":
        return sys.stdin.buffer
    if src.startswith("tcp:"):
        import socket

        host, port = src[4:].rsplit(":", 1)
        sock = socket.create_connection((host, int(port)))
        return sock.makefile("rb")
    return open(src, "rb")


def stream_synthetic(f: BinaryIO, duration: float, speed: float = 1.0,
                     points_per_scan: int = 4000, seed: int = 0,
                     realtime: bool = True) -> None:
    """Demo producer: emit a synthetic sequence paced to the sensor clock
    divided by ``speed`` (speed=2 plays twice as fast; realtime=False blasts
    at full pipe bandwidth)."""
    from wildcat_slam_tpu_torch.io.synthetic import SyntheticSequence

    seq = SyntheticSequence(duration=duration, points_per_scan=points_per_scan,
                            room_half=5.0, seed=seed)
    events = [("imu", e[0], e) for e in seq.imu]
    events += [("scan", ts[-1], (ts, pts)) for ts, pts in seq.scans]
    events.sort(key=lambda e: e[1])
    wall0 = time.perf_counter()
    t0 = events[0][1]
    for kind, t, data in events:
        if realtime:
            lag = (t - t0) / speed - (time.perf_counter() - wall0)
            if lag > 0:
                time.sleep(lag)
        if kind == "imu":
            write_imu(f, data[0], data[1], data[2])
        else:
            write_scan(f, data[0], data[1])
        f.flush()
    write_end(f)
    f.flush()


def _main() -> int:
    import argparse
    import sys

    ap = argparse.ArgumentParser(description="synthetic live-stream producer")
    ap.add_argument("--duration", type=float, default=8.0)
    ap.add_argument("--speed", type=float, default=1.0,
                    help="sensor-clock playback multiplier")
    ap.add_argument("--points-per-scan", type=int, default=4000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-realtime", action="store_true",
                    help="emit at full bandwidth instead of pacing")
    args = ap.parse_args()
    stream_synthetic(sys.stdout.buffer, args.duration, args.speed,
                     args.points_per_scan, args.seed, realtime=not args.no_realtime)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(_main())
