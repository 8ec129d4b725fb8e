"""The port's web GUI (gui/app.py over the port's Server) and its CLI's
``--draw-overlays`` and ``--benchmark`` on the CPU: twins of both tests of
tests/test_gui.py at a budget of 4096 rays, and the CLI in process.

Every HTTP server and Server a test starts is shut down in a ``finally``;
every wait and every request has a timeout.
"""

import json
import urllib.error
import urllib.request

import pytest
import torch

from ice_halo_sim_tpu_torch import cli
from ice_halo_sim_tpu_torch.gui.app import serve
from tests.test_e2e import SMOKE_CFG

# Tier-1 runs six workers; keep each one to two torch threads.
torch.set_num_threads(2)

RAYS = 4096
WAIT = 120


def _get(url):
    return urllib.request.urlopen(url, timeout=WAIT).read()


def _post(url, data):
    req = urllib.request.Request(url, data=data, method="POST")
    return urllib.request.urlopen(req, timeout=WAIT).read()


def _serve():
    cfg = dict(SMOKE_CFG)
    cfg["scene"] = dict(SMOKE_CFG["scene"], ray_num=RAYS)
    httpd, gui = serve(json.dumps(cfg), port=0, seed=3, batch_size=4096, block=False,
                       device="cpu")
    return cfg, httpd, gui, f"http://127.0.0.1:{httpd.server_address[1]}"


def test_gui_serves_frames_and_commits():
    cfg, httpd, gui, base = _serve()
    try:
        assert gui.server.wait_idle(timeout=WAIT)

        assert b"live view" in _get(base + "/")

        status = json.loads(_get(base + "/status"))
        assert status["ray_count"] >= RAYS
        assert status["renders"] == 1
        assert status["is_idle"] is True

        png = _get(base + "/frame/0.png")
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        png_ev = _get(base + "/frame/0.png?ev=2.0")
        assert png_ev[:8] == b"\x89PNG\r\n\x1a\n"
        assert png_ev != png

        cfg2 = json.loads(json.dumps(cfg))
        cfg2["render"][0]["intensity_factor"] = 2.0
        assert json.loads(_post(base + "/commit", json.dumps(cfg2).encode()))["reused"] is True

        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(base + "/commit", b"{not json")
        assert exc.value.code == 400
        status = json.loads(_get(base + "/status"))
        assert status["renders"] == 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        gui.server.shutdown()


def test_gui_shows_the_committed_scene_after_idle():
    """A scene runs to idle (its frame is final and cached), then /commit
    takes a different scene and then an appearance-only change of it: each
    time /frame/0.png shows the committed scene, not the cached frame (the
    JAX package's viewer keeps the finished frame)."""
    from ice_halo_sim_tpu_torch.utils.png import encode_png

    cfg, httpd, gui, base = _serve()
    try:
        assert gui.server.wait_idle(timeout=WAIT)
        first = _get(base + "/frame/0.png")
        assert gui.frame().is_idle and _get(base + "/frame/0.png") == first

        cfg2 = json.loads(json.dumps(cfg))
        cfg2["scene"]["light_source"]["altitude"] = 5.0
        gen = gui.server.generation()
        assert json.loads(_post(base + "/commit", json.dumps(cfg2).encode()))["reused"] is False
        assert gui.server.wait_idle(timeout=WAIT) and gui.server.generation() == gen + 1
        second = _get(base + "/frame/0.png")
        assert second != first
        assert second == encode_png(gui.server.acquire_frame().images[0])

        cfg3 = json.loads(json.dumps(cfg2))
        cfg3["render"][0]["intensity_factor"] = 3.0
        assert json.loads(_post(base + "/commit", json.dumps(cfg3).encode()))["reused"] is True
        third = _get(base + "/frame/0.png")
        assert third != second and gui.server.generation() == gen + 1
        assert third == encode_png(gui.server.acquire_frame().images[0])
    finally:
        httpd.shutdown()
        httpd.server_close()
        gui.server.shutdown()


def test_gui_project_roundtrip_and_crystal_mesh():
    _, httpd, gui, base = _serve()
    try:
        assert gui.server.wait_idle(timeout=WAIT)

        status = json.loads(_get(base + "/status"))
        assert status["crystals"], status

        saved = _get(base + "/project")
        proj = json.loads(saved)
        assert "crystal" in proj and "scene" in proj
        assert json.loads(_post(base + "/commit", saved))["reused"] is True

        cid = status["crystals"][0]
        mesh = json.loads(_get(base + f"/crystal/{cid}.json"))
        nv, nt = len(mesh["vertices"]), len(mesh["triangles"])
        assert nv >= 8 and nt >= 2 * nv - 4
        assert all(len(v) == 3 for v in mesh["vertices"])
        assert all(0 <= i < nv for tri in mesh["triangles"] for i in tri)

        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(base + "/crystal/999.json")
        assert exc.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        gui.server.shutdown()


def _scene_file(tmp_path, doc):
    path = tmp_path / "smoke.json"
    path.write_text(json.dumps(doc))
    return str(path)


def test_cli_draw_overlays(tmp_path):
    """The overlay lands on the PNG: the 22-degree circle around the zenith
    sun and the horizon outline (half-opacity white) change pixels."""
    doc = json.loads(json.dumps(SMOKE_CFG))
    doc["render"][0]["grid"] = {"central": [{"value": 22, "color": [1, 0, 0]}]}
    path = _scene_file(tmp_path, doc)
    args = [path, "--ray-num", str(RAYS), "--device", "cpu", "--seed", "3"]
    plain, drawn = tmp_path / "plain", tmp_path / "drawn"
    assert cli.main(args + ["-o", str(plain)]) == 0
    assert cli.main(args + ["-o", str(drawn), "--draw-overlays"]) == 0
    a = (plain / "smoke_render1.png").read_bytes()
    b = (drawn / "smoke_render1.png").read_bytes()
    assert a[:8] == b[:8] == b"\x89PNG\r\n\x1a\n" and a != b


def test_cli_benchmark_line(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("IHT_STEPS_PER_DISPATCH", "2")
    path = _scene_file(tmp_path, SMOKE_CFG)
    rc = cli.main([path, "--benchmark", "--ray-num", "20000", "--batch-size", "4096",
                   "--device", "cpu"])
    assert rc == 0
    line = next(l for l in capsys.readouterr().out.splitlines() if l.startswith("[BENCHMARK] "))
    rec = json.loads(line[len("[BENCHMARK] "):])
    assert rec["mode"] == "multi" and rec["workers"] == 1 and rec["platform"] == "cpu"
    assert rec["batch_size"] == 4096 and rec["rays"] == 20480  # 5 batches of 4096
    assert rec["rate_basis"] in ("steady", "active_short")
    assert rec["active_sec"] > 0 and rec["setup_sec"] > 0
    assert rec["rays_per_sec"] == pytest.approx(rec["rays"] / rec["active_sec"], rel=0.01)
    assert rec["wall_sec"] >= rec["active_sec"] + rec["setup_sec"] - 0.01
