"""Live viewer service tests: the RsViewer Loop analog
(rs_viewer.cpp:67-117) -- stale-frame interval/8 pacing, HTTP live view,
atomic latest-frame file, record-while-viewing."""

import io
import json
import os
import urllib.request

import numpy as np
import pytest

from realsensetracker_tpu.vis import live


class TestPngEncoder:
    def test_roundtrip_via_matplotlib(self):
        rng = np.random.RandomState(0)
        rgb = rng.randint(0, 256, (16, 24, 3), np.uint8)
        png = live.encode_png(rgb)
        assert png.startswith(b"\x89PNG\r\n\x1a\n")
        import matplotlib.pyplot as plt

        back = plt.imread(io.BytesIO(png))
        np.testing.assert_array_equal(
            (back[..., :3] * 255).round().astype(np.uint8), rgb
        )

    def test_depth_colormap(self):
        d = np.array([[0.0, 0.1], [2.5, 5.0]], np.float32)
        rgb = live.depth_to_rgb(d, max_depth=5.0)
        assert rgb.shape == (2, 2, 3)
        assert (rgb[0, 0] == 0).all()  # invalid -> black
        assert (rgb[0, 1] != rgb[1, 1]).any()  # near != far

    def test_depth_colormap_nonfinite_is_black(self):
        # floor(NaN).astype(int32) is INT32_MIN: without the finite mask
        # the colormap gather raised IndexError and killed the viewer loop.
        d = np.array([[np.nan, 1.0], [np.inf, -np.inf]], np.float32)
        rgb = live.depth_to_rgb(d, max_depth=5.0)
        assert (rgb[0, 0] == 0).all()
        assert (rgb[1, 0] == 0).all() and (rgb[1, 1] == 0).all()
        assert (rgb[0, 1] != 0).any()  # valid pixel still colored


class _FakeStream:
    """Scripted poll() sequence: None entries are stale polls."""

    def __init__(self, script):
        self._script = list(script)
        self.exhausted = False

    def poll(self):
        if not self._script:
            self.exhausted = True
            return None
        item = self._script.pop(0)
        return item


class TestViewerLoop:
    def test_stale_sleeps_interval_over_8(self):
        # rs_viewer.cpp:82-86: stale frame -> sleep interval/8.
        script = [None, (0.0, "a"), None, None, (0.1, "b")]
        stream = _FakeStream(script)
        sleeps, frames = [], []
        shown = live.viewer_loop(
            stream,
            lambda ts, f: frames.append((ts, f)),
            frame_interval_s=0.8,
            sleep=sleeps.append,
        )
        assert shown == 2
        assert frames == [(0.0, "a"), (0.1, "b")]
        assert sleeps == [0.1, 0.1, 0.1]  # 0.8 / 8 per stale poll

    def test_max_frames_stops_early(self):
        stream = _FakeStream([(i, i) for i in range(10)])
        shown = live.viewer_loop(stream, lambda *a: None, max_frames=3)
        assert shown == 3

    def test_exhausted_source_terminates(self):
        stream = _FakeStream([(0, 0)])
        shown = live.viewer_loop(stream, lambda *a: None)
        assert shown == 1
        assert stream.exhausted


class TestLiveServer:
    def test_serves_latest_frame_and_status(self):
        server = live.LiveServer(port=0)
        try:
            rgb = np.full((4, 6, 3), 200, np.uint8)
            png = live.encode_png(rgb)
            server.update(png, {"frame": 7})
            base = f"http://127.0.0.1:{server.port}"
            got = urllib.request.urlopen(f"{base}/frame.png", timeout=5).read()
            assert got == png
            status = json.loads(
                urllib.request.urlopen(f"{base}/status", timeout=5).read()
            )
            assert status == {"frame": 7, "cloud_seq": 0}
            page = urllib.request.urlopen(f"{base}/", timeout=5).read()
            assert b"/frame.png" in page
        finally:
            server.close()

    def test_update_replaces_frame(self):
        server = live.LiveServer(port=0)
        try:
            base = f"http://127.0.0.1:{server.port}"
            a = live.encode_png(np.zeros((2, 2, 3), np.uint8))
            b = live.encode_png(np.full((2, 2, 3), 255, np.uint8))
            server.update(a)
            server.update(b)
            got = urllib.request.urlopen(f"{base}/frame.png", timeout=5).read()
            assert got == b
        finally:
            server.close()


class TestWriteLatest:
    def test_atomic_replace(self, tmp_path):
        path = str(tmp_path / "latest.png")
        live.write_latest_png(path, b"one")
        live.write_latest_png(path, b"two")
        with open(path, "rb") as f:
            assert f.read() == b"two"
        assert not os.path.exists(path + ".tmp")


class TestViewerCliLoop:
    def test_loop_records_and_writes_latest(self, tmp_path):
        from realsensetracker_tpu.cli import rs_viewer
        from realsensetracker_tpu.data import recorded

        clip_path = str(tmp_path / "live.rsc")
        latest = str(tmp_path / "latest.png")
        rc = rs_viewer.main([
            "--loop", "--frames", "4", "--width", "32", "--height", "24",
            "--record", clip_path, "--live-latest", latest,
        ])
        assert rc == 0
        assert os.path.exists(latest)
        clip = recorded.read_clip(clip_path)
        assert len(clip) == 4
        assert clip.depths.shape[1:] == (24, 32)

    def test_replay_live_latest(self, tmp_path):
        from realsensetracker_tpu.cli import rs_replay, rs_viewer
        from realsensetracker_tpu.data import recorded  # noqa: F401

        clip_path = str(tmp_path / "in.rsc")
        rs_viewer.main([
            "--record", clip_path, "--frames", "3",
            "--width", "64", "--height", "48",
        ])
        latest = str(tmp_path / "tracked.png")
        rc = rs_replay.main([
            "--record", clip_path, "--live-latest", latest,
            "--method", "projective",
        ])
        assert rc == 0
        assert os.path.exists(latest)


class TestOrbitViewer:
    """Interactive 3-D view: /orbit page +
    /cloud.bin binary snapshots (vis/live.py pack_cloud)."""

    def test_pack_cloud_layout_roundtrip(self):
        import struct

        pts = np.arange(12, dtype=np.float32).reshape(4, 3)
        cols = np.asarray([[1.0, 0.0, 0.5]] * 4)
        traj = np.asarray([[0, 0, 0], [1.0, 2.0, 3.0]], np.float32)
        blob = live.pack_cloud(pts, cols, traj)
        magic, n, has_c, t = struct.unpack_from("<4sIB3xI", blob, 0)
        assert (magic, n, has_c, t) == (b"RSC1", 4, 1, 2)
        off = 16
        got_pts = np.frombuffer(blob, np.float32, 12, off).reshape(4, 3)
        np.testing.assert_array_equal(got_pts, pts)
        off += 48
        got_c = np.frombuffer(blob, np.uint8, 12, off).reshape(4, 3)
        np.testing.assert_array_equal(got_c[0], [255, 0, 127])
        off += 12
        got_t = np.frombuffer(blob, np.float32, 6, off).reshape(2, 3)
        np.testing.assert_array_equal(got_t, traj)

    def test_pack_cloud_color_count_mismatch(self):
        with pytest.raises(ValueError, match="colors"):
            live.pack_cloud(np.zeros((4, 3)), np.zeros((3, 3)))

    def test_server_cloud_endpoints(self):
        server = live.LiveServer(port=0)
        try:
            base = f"http://127.0.0.1:{server.port}"
            page = urllib.request.urlopen(f"{base}/orbit", timeout=5).read()
            assert b"webgl" in page and b"cloud.bin" in page
            st0 = json.loads(
                urllib.request.urlopen(f"{base}/status", timeout=5).read()
            )
            assert st0["cloud_seq"] == 0
            pts = np.random.RandomState(0).randn(100, 3).astype(np.float32)
            server.update_cloud(pts, trajectory=np.zeros((3, 3)))
            blob = urllib.request.urlopen(
                f"{base}/cloud.bin", timeout=5).read()
            assert blob[:4] == b"RSC1"
            assert len(blob) == 16 + 100 * 12 + 3 * 12
            st = json.loads(
                urllib.request.urlopen(f"{base}/status", timeout=5).read()
            )
            assert st["cloud_seq"] == 1
            # Pre-packed blobs pass through byte-identical.
            server.update_cloud(live.pack_cloud(pts[:5]))
            blob2 = urllib.request.urlopen(
                f"{base}/cloud.bin", timeout=5).read()
            assert blob2 == live.pack_cloud(pts[:5])
        finally:
            server.close()
