"""Minimal pure-python ROS1 ``.bag`` reader (and writer, for tests).

A copy of ``wildcat_slam_tpu/io/rosbag.py`` (numpy only; held equal to it by
a test), so that the port imports nothing of the JAX package.

The reference consumes Hilti-2021 rosbags directly (wildcat_slam_node.cc:80-99:
``rosbag::View`` over ``sensor_msgs/Imu`` on /alphasense/imu and
``sensor_msgs/PointCloud2`` on /hesai/pandar, with the per-point layout of
hilti_ros::Point — x/y/z/intensity float32, absolute ``time`` float64, ``ring``
uint16, common.h:12-28). This module reads the same bags without any ROS
dependency so a user of the reference can feed their data unchanged:

    for kind, *payload in read_bag("seq.bag"):
        if kind == "imu":   t, acc, gyr = payload
        else:               times, points = payload   # lidar frame

Supports bag format 2.0 with 'none' and 'bz2' chunk compression (stdlib); 'lz4'
is gated on the optional lz4 package. Only the two message types the pipeline
needs are deserialized; other topics are skipped.
"""

from __future__ import annotations

import bz2
import struct
from typing import Iterator, Optional, Tuple

import numpy as np

_OP_BAG_HEADER = 0x03
_OP_CHUNK = 0x05
_OP_CONNECTION = 0x07
_OP_MESSAGE = 0x02
_OP_INDEX = 0x04
_OP_CHUNK_INFO = 0x06


def _parse_header(buf: bytes) -> dict:
    fields = {}
    off = 0
    n = len(buf)
    while off < n:
        if off + 4 > n:
            raise ValueError("corrupt record header: truncated field length")
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        if off + flen > n:
            raise ValueError("corrupt record header: field runs past the buffer")
        entry = buf[off : off + flen]
        off += flen
        k, _, v = entry.partition(b"=")
        fields[k.decode(errors="replace")] = v
    return fields


def _records(buf: bytes) -> Iterator[Tuple[dict, bytes]]:
    """Iterate (header, data) records of a decompressed chunk. Malformed
    structure (lengths running past the buffer — bit rot, a bad disk, a
    corrupted transfer) raises ValueError rather than yielding garbage or
    crashing with a struct.error (tests/test_rosbag.py::TestCorruption)."""
    off = 0
    n = len(buf)
    while off + 4 <= n:
        (hlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        if off + hlen + 4 > n:
            raise ValueError(f"corrupt chunk: record header at {off - 4} "
                             "runs past the chunk")
        header = _parse_header(buf[off : off + hlen])
        off += hlen
        (dlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        if off + dlen > n:
            raise ValueError(f"corrupt chunk: record data at {off - 4} "
                             "runs past the chunk")
        data = buf[off : off + dlen]
        off += dlen
        yield header, data


def _read_string(buf: bytes, off: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from("<I", buf, off)
    return buf[off + 4 : off + 4 + n].decode(errors="replace"), off + 4 + n


def _parse_imu(data: bytes):
    """sensor_msgs/Imu -> (t, acc (3,), gyr (3,)); t from the header stamp."""
    off = 4  # seq
    secs, nsecs = struct.unpack_from("<II", data, off)
    off += 8
    (n,) = struct.unpack_from("<I", data, off)
    off += 4 + n
    off += 4 * 8      # orientation quaternion
    off += 9 * 8      # orientation covariance
    gyr = np.frombuffer(data, "<f8", 3, off)
    off += 3 * 8 + 9 * 8
    acc = np.frombuffer(data, "<f8", 3, off)
    return secs + nsecs * 1e-9, acc.copy(), gyr.copy()


_DATATYPE_NP = {1: "i1", 2: "u1", 3: "i2", 4: "u2", 5: "i4", 6: "u4", 7: "f4", 8: "f8"}


def _parse_pointcloud2(data: bytes):
    """sensor_msgs/PointCloud2 -> (times (N,) f64 absolute, points (N, 3) f64).

    Field discovery is by name: x/y/z plus a per-point time field named
    ``time`` | ``t`` | ``timestamp`` | ``time_stamp`` (absolute f64 in the
    Hilti layout; a relative f32 field is added to the header stamp)."""
    off = 4
    secs, nsecs = struct.unpack_from("<II", data, off)
    stamp = secs + nsecs * 1e-9
    off += 8
    (n,) = struct.unpack_from("<I", data, off)
    off += 4 + n
    height, width = struct.unpack_from("<II", data, off)
    off += 8
    (nf,) = struct.unpack_from("<I", data, off)
    off += 4
    fields = {}
    for _ in range(nf):
        name, off = _read_string(data, off)
        foff, dtype_code, count = struct.unpack_from("<IBI", data, off)
        off += 9
        fields[name] = (foff, dtype_code, count)
    is_bigendian = data[off]
    off += 1
    point_step, row_step = struct.unpack_from("<II", data, off)
    off += 8
    (dlen,) = struct.unpack_from("<I", data, off)
    off += 4
    raw = np.frombuffer(data, np.uint8, dlen, off).reshape(-1, point_step)
    npts = raw.shape[0]
    if is_bigendian:
        raise ValueError("big-endian PointCloud2 not supported")

    def col(name):
        foff, code, _ = fields[name]
        dt = np.dtype("<" + _DATATYPE_NP[code])
        return raw[:, foff : foff + dt.itemsize].copy().view(dt)[:, 0]

    xyz = np.stack([col("x").astype(np.float64),
                    col("y").astype(np.float64),
                    col("z").astype(np.float64)], axis=1)
    tname = next((c for c in ("time", "t", "timestamp", "time_stamp") if c in fields), None)
    if tname is None:
        times = np.full(npts, stamp)
    else:
        tvals = col(tname).astype(np.float64)
        # absolute per-point stamps sit near the header stamp (Hilti layout);
        # otherwise the field holds offsets from the header stamp
        absolute = tvals.size and abs(tvals[0] - stamp) < 10.0
        times = tvals if absolute else stamp + tvals
    order = np.argsort(times, kind="stable")
    return times[order], xyz[order]


def _decompress_chunk(header: dict, data: bytes) -> bytes:
    compression = header.get("compression", b"none").decode()
    if compression == "none":
        return data
    if compression == "bz2":
        try:
            return bz2.decompress(data)
        except OSError as e:
            raise ValueError(f"corrupt bz2 chunk: {e}") from e
    if compression == "lz4":
        try:
            import lz4.frame
        except ImportError as e:
            raise ImportError("bag uses lz4 chunks; optional lz4 package required") from e
        return lz4.frame.decompress(data)
    raise ValueError(f"unknown chunk compression {compression!r}")


def read_bag(
    path: str,
    imu_topic: Optional[str] = None,
    lidar_topic: Optional[str] = None,
) -> Iterator[tuple]:
    """Yield ("imu", t, acc, gyr) and ("scan", times, points_lidar) events in
    file order (rosbag chunks are time-ordered in practice, matching the
    reference's rosbag::View iteration). Topics default to any connection of
    the matching message type.

    Streaming: records are read one at a time and only one (decompressed)
    chunk is resident at once, so multi-GB bags never get slurped into memory;
    index/chunk-info records at the tail are seeked over without reading.
    Truncated files raise ValueError at the cut, after yielding every complete
    message before it.
    """

    def handle_message(h, d):
        conn = struct.unpack("<I", h["conn"])[0]
        topic, mtype = connections.get(conn, ("", ""))
        if mtype == "sensor_msgs/Imu" and (imu_topic is None or topic == imu_topic):
            return ("imu", *_parse_imu(d))
        if mtype == "sensor_msgs/PointCloud2" and (
            lidar_topic is None or topic == lidar_topic
        ):
            return ("scan", *_parse_pointcloud2(d))
        return None

    def handle_connection(h, d):
        conn = struct.unpack("<I", h["conn"])[0]
        chdr = _parse_header(d)
        connections[conn] = (h.get("topic", b"").decode(),
                             chdr.get("type", b"").decode())

    import os

    connections = {}  # conn id -> (topic, type)
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        magic = f.readline()
        if not magic.startswith(b"#ROSBAG V2.0"):
            raise ValueError(f"{path}: not a ROS1 bag v2.0 (got {magic[:20]!r})")
        while True:
            pos = f.tell()
            lb = f.read(4)
            if not lb:
                return  # clean EOF
            if len(lb) < 4:
                raise ValueError(f"{path}: truncated record length at offset {pos}")
            (hlen,) = struct.unpack("<I", lb)
            hbuf = f.read(hlen)
            lb2 = f.read(4)
            if len(hbuf) < hlen or len(lb2) < 4:
                raise ValueError(f"{path}: truncated record header at offset {pos}")
            header = _parse_header(hbuf)
            (dlen,) = struct.unpack("<I", lb2)
            op = header.get("op", b"\x00")[0]
            if op == _OP_CONNECTION:
                data = f.read(dlen)
                if len(data) < dlen:
                    raise ValueError(f"{path}: truncated connection record at offset {pos}")
                handle_connection(header, data)
            elif op == _OP_CHUNK:
                data = f.read(dlen)
                if len(data) < dlen:
                    raise ValueError(f"{path}: truncated chunk at offset {pos}")
                try:
                    for h2, d2 in _records(_decompress_chunk(header, data)):
                        op2 = h2.get("op", b"\x00")[0]
                        if op2 == _OP_CONNECTION:
                            handle_connection(h2, d2)
                        elif op2 == _OP_MESSAGE:
                            ev = handle_message(h2, d2)
                            if ev is not None:
                                yield ev
                except struct.error as e:
                    # garbage inside a structurally-plausible record (message
                    # deserialization ran off the end)
                    raise ValueError(
                        f"{path}: corrupt message in chunk at offset {pos}: {e}"
                    ) from e
                except ValueError as e:
                    raise ValueError(
                        f"{path}: chunk at offset {pos}: {e}") from e
            elif op == _OP_MESSAGE:  # unchunked message (legal, rare)
                data = f.read(dlen)
                if len(data) < dlen:
                    raise ValueError(f"{path}: truncated message at offset {pos}")
                ev = handle_message(header, data)
                if ev is not None:
                    yield ev
            else:
                # bag header / index / chunk-info: skip without reading
                f.seek(dlen, 1)
                if f.tell() > size:
                    raise ValueError(f"{path}: truncated record at offset {pos}")


def convert_bag(bag_path: str, out_dir: str, imu_topic=None, lidar_topic=None) -> dict:
    """Convert a bag into the .wcs/imu.npz sequence layout (io/dataset.py)."""
    from wildcat_slam_tpu_torch.io.dataset import save_sequence

    imu, scans = [], []
    for ev in read_bag(bag_path, imu_topic, lidar_topic):
        if ev[0] == "imu":
            imu.append(ev[1:])
        else:
            scans.append((ev[1], ev[2].astype(np.float32)))
    save_sequence(out_dir, imu, scans)
    return {"imu": len(imu), "scans": len(scans)}


# ---------------------------------------------------------------------------
# Writer — enough of the format to round-trip our own reader in tests and to
# package synthetic sequences as bags.
# ---------------------------------------------------------------------------

def _header(fields: dict) -> bytes:
    out = b""
    for k, v in fields.items():
        entry = k.encode() + b"=" + v
        out += struct.pack("<I", len(entry)) + entry
    return out


def _record(fields: dict, data: bytes) -> bytes:
    h = _header(fields)
    return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data


def _ros_time(t: float) -> bytes:
    secs = int(t)
    return struct.pack("<II", secs, int(round((t - secs) * 1e9)))


def _ser_string(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<I", len(b)) + b


def _ser_imu(t: float, acc, gyr) -> bytes:
    out = struct.pack("<I", 0) + _ros_time(t) + _ser_string("imu")
    out += struct.pack("<4d", 0, 0, 0, 1) + struct.pack("<9d", *([0.0] * 9))
    out += struct.pack("<3d", *gyr) + struct.pack("<9d", *([0.0] * 9))
    out += struct.pack("<3d", *acc) + struct.pack("<9d", *([0.0] * 9))
    return out


def _ser_pointcloud2(times: np.ndarray, pts: np.ndarray, layout: str = "hilti") -> bytes:
    """Serialize one PointCloud2. ``layout`` selects the per-point format:

    - "hilti": x,y,z,intensity f32 + absolute ``time`` f64 + ring u16
      (common.h:12-28) — the reference's format;
    - "permuted": same fields in a scrambled declaration order with extra
      unknown fields interleaved (field discovery must be by name);
    - "relative_f32": per-point time as a relative f32 ``t`` field offset from
      the header stamp (Ouster/Velodyne convention).
    """
    n = len(times)
    stamp = float(times[0]) if n else 0.0
    if layout == "hilti":
        fdefs = [("x", 0, 7), ("y", 4, 7), ("z", 8, 7), ("intensity", 12, 7),
                 ("time", 16, 8), ("ring", 24, 4)]
        point_step = 26
    elif layout == "permuted":
        fdefs = [("ring", 0, 4), ("time", 2, 8), ("reflectivity", 10, 4),
                 ("z", 12, 7), ("x", 16, 7), ("intensity", 20, 7), ("y", 24, 7),
                 ("ambient", 28, 4)]
        point_step = 30
    elif layout == "relative_f32":
        fdefs = [("x", 0, 7), ("y", 4, 7), ("z", 8, 7), ("t", 12, 7), ("ring", 16, 4)]
        point_step = 18
    else:
        raise ValueError(f"unknown test layout {layout!r}")

    out = struct.pack("<I", 0) + _ros_time(stamp) + _ser_string("lidar")
    out += struct.pack("<II", 1, n)
    out += struct.pack("<I", len(fdefs))
    for name, foff, code in fdefs:
        out += _ser_string(name) + struct.pack("<IBI", foff, code, 1)
    out += struct.pack("<B", 0)
    out += struct.pack("<II", point_step, point_step * n)
    raw = np.zeros((n, point_step), np.uint8)
    offs = {name: foff for name, foff, _ in fdefs}
    xyz32 = np.ascontiguousarray(pts.astype("<f4")).view(np.uint8).reshape(n, 12)
    for k, ax in enumerate("xyz"):
        raw[:, offs[ax]:offs[ax] + 4] = xyz32[:, 4 * k:4 * k + 4]
    if layout == "relative_f32":
        rel = np.ascontiguousarray((times - stamp).astype("<f4")).view(np.uint8)
        raw[:, offs["t"]:offs["t"] + 4] = rel.reshape(n, 4)
    else:
        t64 = np.ascontiguousarray(times.astype("<f8")).view(np.uint8).reshape(n, 8)
        raw[:, offs["time"]:offs["time"] + 8] = t64
    out += struct.pack("<I", point_step * n) + raw.tobytes()
    out += struct.pack("<B", 1)
    return out


def write_bag(path: str, events, imu_topic="/alphasense/imu", lidar_topic="/hesai/pandar",
              compression: str = "none", layout: str = "hilti",
              messages_per_chunk: int = 0) -> None:
    """events: iterable of ("imu", t, acc, gyr) | ("scan", times, points) |
    ("other", t, raw_bytes) — the last writes a message of an unrelated type
    (nav_msgs/Odometry) on its own topic, for reader skip-coverage tests.

    ``compression``: "none" | "bz2" per chunk. ``layout``: PointCloud2 field
    layout (see _ser_pointcloud2). ``messages_per_chunk`` > 0 splits the stream
    into multiple chunks of that many messages (0 = single chunk)."""
    conns = {imu_topic: (0, "sensor_msgs/Imu"), lidar_topic: (1, "sensor_msgs/PointCloud2"),
             "/odom_extra": (2, "nav_msgs/Odometry")}
    conn_records = b""
    for topic, (cid, mtype) in conns.items():
        conn_hdr = _header({"topic": topic.encode(), "type": mtype.encode(),
                            "md5sum": b"0" * 32, "message_definition": b""})
        conn_records += _record({"op": bytes([_OP_CONNECTION]), "conn": struct.pack("<I", cid),
                                 "topic": topic.encode()}, conn_hdr)

    # chunks stream to disk as they fill — only one chunk is ever resident,
    # so multi-GB test bags (TestSoak) write in bounded memory. chunk_count
    # in the bag header is left 0 (readers that honor it re-scan; ours
    # iterates records directly).
    with open(path, "wb") as f:
        f.write(b"#ROSBAG V2.0\n")
        f.write(_record({"op": bytes([_OP_BAG_HEADER]), "index_pos": struct.pack("<Q", 0),
                         "conn_count": struct.pack("<I", len(conns)),
                         "chunk_count": struct.pack("<I", 0)}, b" " * 4096))

        def flush(parts):
            chunk = b"".join(parts)
            payload = bz2.compress(chunk) if compression == "bz2" else chunk
            f.write(_record({"op": bytes([_OP_CHUNK]), "compression": compression.encode(),
                             "size": struct.pack("<I", len(chunk))}, payload))

        cur = [conn_records]
        n_in_cur = 0
        for ev in events:
            if ev[0] == "imu":
                _, t, acc, gyr = ev
                cur.append(_record({"op": bytes([_OP_MESSAGE]),
                                    "conn": struct.pack("<I", 0), "time": _ros_time(t)},
                                   _ser_imu(t, acc, gyr)))
            elif ev[0] == "other":
                _, t, raw = ev
                cur.append(_record({"op": bytes([_OP_MESSAGE]),
                                    "conn": struct.pack("<I", 2), "time": _ros_time(t)},
                                   bytes(raw)))
            else:
                _, times, pts = ev
                cur.append(_record({"op": bytes([_OP_MESSAGE]),
                                    "conn": struct.pack("<I", 1),
                                    "time": _ros_time(float(times[0]) if len(times) else 0.0)},
                                   _ser_pointcloud2(np.asarray(times), np.asarray(pts), layout)))
            n_in_cur += 1
            if messages_per_chunk and n_in_cur >= messages_per_chunk:
                flush(cur)
                cur, n_in_cur = [], 0
        if cur:
            flush(cur)
