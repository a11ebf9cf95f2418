"""The port's interactive viewer (`raymarch_tpu_torch.viewer`).

Case by case the tests of tests/test_viewer.py, on the CPU (`device="cpu"`,
the "jnp" backend): ViewerApp headless (the per-frame pipeline: event ->
camera, graph edit -> tape swap -> render) plus end-to-end passes through
the real HTTP server on a loopback socket (port 0); then the port's own:
the default device is the card, and the kernel backend's tiered frames on
the CPU.
"""

import json
import struct
import threading
import urllib.request
import zlib

import numpy as np
import pytest

import torch

import raymarch_tpu_torch as rt
from raymarch_tpu_torch.viewer import ViewerApp, default_graph, main, make_server

# One torch thread per process (see tests/test_torch_prepass.py).
torch.set_num_threads(1)

W, H = 64, 36
CFG = rt.RenderConfig(aa_samples=1, max_iter=48)


@pytest.fixture(scope="module")
def app():
    return ViewerApp(width=W, height=H, cfg=CFG, backend="jnp", device="cpu")


def _decode_png(data: bytes):
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", data[16:24])
    # Single IDAT written by utils.image.png_bytes; filter 0 per scanline.
    n = struct.unpack(">I", data[33:37])[0]
    assert data[37:41] == b"IDAT"
    raw = zlib.decompress(data[41 : 41 + n])
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + w * 3)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


class TestHeadless:
    def test_frame_renders_scene(self, app):
        img = app.frame()
        assert img.shape == (H, W, 3)
        assert np.isfinite(img).all() and img.max() > 0.05

    def test_orbit_event_moves_camera(self, app):
        before = app.frame()
        app.handle_event({"type": "orbit", "dx": 120.0, "dy": 0.0})
        after = app.frame()
        assert np.abs(after - before).max() > 1e-3
        app.handle_event({"type": "orbit", "dx": -120.0, "dy": 0.0})

    def test_dolly_and_pan_match_controller_semantics(self, app):
        r0 = app.camera.radius
        app.handle_event({"type": "dolly", "delta": 100.0})
        assert app.camera.radius == pytest.approx(r0 * (1 + 100.0 * 0.01))
        t0 = app.camera.target.copy()
        app.handle_event({"type": "pan", "dx": 10.0, "dy": 0.0})
        assert np.linalg.norm(app.camera.target - t0) > 0
        app.handle_event({"type": "dolly", "delta": -100.0 / (1 + 1.0)})

    def test_unknown_event_rejected(self, app):
        with pytest.raises(ValueError):
            app.handle_event({"type": "warp"})

    def test_param_edit_reuses_compiled_program(self, app):
        app.frame()
        compiles0 = app.compiles
        g = app.graph_dict()
        sphere = next(n for n in g["nodes"] if n["template"] == "Sphere")
        sphere["inputs"]["radius"] = 1.3
        before = app.frame()
        app.set_graph(g)
        after = app.frame()
        assert app.compiles == compiles0  # tape swap only, no new program
        assert np.abs(after - before).max() > 1e-3  # but the edit is visible

    def test_structural_edit_compiles_new_program(self, app):
        g = app.graph_dict()
        nid = 1 + max(n["id"] for n in g["nodes"])
        root = next(n for n in g["nodes"] if n["template"] == "Root")
        old_sdf = root["inputs"]["SDF"]
        g["nodes"].append(
            {
                "id": nid,
                "template": "Union",
                "inputs": {"A": old_sdf, "B": {"$node": nid + 1}},
            }
        )
        g["nodes"].append(
            {
                "id": nid + 1,
                "template": "Sphere",
                "inputs": {"center": [0.0, 1.8, 0.0], "radius": 0.4},
            }
        )
        root["inputs"]["SDF"] = {"$node": nid}
        compiles0 = app.compiles
        before = app.frame()
        app.set_graph(g)
        after = app.frame()
        # Even a STRUCTURAL edit stays within the padded tape bucket: the
        # extra sphere+union render through the same compiled program
        # (tape.compile_scene bucketing; reference README.md:7 "modify the
        # SDF graph at runtime" without shader recompiles).
        assert app.compiles == compiles0
        assert np.abs(after - before).max() > 1e-3

    def test_bad_graph_rejected_and_state_kept(self, app):
        before = app.graph_dict()
        with pytest.raises(KeyError):
            app.set_graph({"nodes": [{"id": 0, "template": "Blob", "inputs": {}}]})
        assert app.graph_dict() == before

    def test_empty_graph_renders_background(self):
        a = ViewerApp(
            graph=rt.CSGNodeGraph(), width=W, height=H, cfg=CFG, backend="jnp", device="cpu"
        )
        img = a.frame()
        assert np.isfinite(img).all()  # background/floor only, no NaNs


class TestHTTP:
    @pytest.fixture(scope="class")
    def server(self):
        app = ViewerApp(width=W, height=H, cfg=CFG, backend="jnp", device="cpu")
        srv = make_server(app, port=0)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        yield f"http://127.0.0.1:{srv.server_address[1]}", app
        srv.shutdown()
        srv.server_close()

    def test_index_and_state(self, server):
        url, app = server
        html = urllib.request.urlopen(url + "/").read()
        assert b"raymarch_tpu" in html
        state = json.loads(urllib.request.urlopen(url + "/state").read())
        assert state["size"] == [W, H] and state["backend"] == "jnp"

    def test_frame_png_roundtrip(self, server):
        url, app = server
        data = urllib.request.urlopen(url + "/frame.png").read()
        img = _decode_png(data)
        assert img.shape == (H, W, 3) and img.max() > 10

    def test_event_and_graph_endpoints(self, server):
        url, app = server
        png0 = urllib.request.urlopen(url + "/frame.png").read()
        req = urllib.request.Request(
            url + "/event",
            data=json.dumps({"type": "orbit", "dx": 150.0, "dy": 30.0}).encode(),
        )
        assert urllib.request.urlopen(req).status == 200
        png1 = urllib.request.urlopen(url + "/frame.png").read()
        assert png0 != png1

        g = json.loads(urllib.request.urlopen(url + "/graph").read())
        sphere = next(n for n in g["nodes"] if n["template"] == "Sphere")
        sphere["inputs"]["radius"] = 1.4
        req = urllib.request.Request(url + "/graph", data=json.dumps(g).encode())
        assert urllib.request.urlopen(req).status == 200
        g2 = json.loads(urllib.request.urlopen(url + "/graph").read())
        s2 = next(n for n in g2["nodes"] if n["template"] == "Sphere")
        assert s2["inputs"]["radius"] == 1.4

    def test_bad_graph_returns_400(self, server):
        url, app = server
        req = urllib.request.Request(url + "/graph", data=b'{"nodes": [{"id"')
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req)
        assert e.value.code == 400

    def test_templates_endpoint(self, server):
        url, app = server
        tpl = json.loads(urllib.request.urlopen(url + "/templates").read())
        assert "Sphere" in tpl and "Root" in tpl and "SmoothUnion" in tpl
        sphere = {s["name"]: s for s in tpl["Sphere"]}
        assert sphere["radius"]["kind"] == "scalar"
        assert sphere["center"]["kind"] == "vec3"
        root = {s["name"]: s for s in tpl["Root"]}
        assert root["SDF"]["kind"] == "sdf"

    def test_edit_endpoint_builds_scene(self, server):
        """The visual editor's op stream: create/connect/edit a scene
        without ever POSTing JSON graphs (reference editor interactions,
        csg_node_graph.rs:185-206)."""
        url, app = server

        def edit(op):
            req = urllib.request.Request(
                url + "/edit", data=json.dumps(op).encode()
            )
            return json.loads(urllib.request.urlopen(req).read())

        png0 = urllib.request.urlopen(url + "/frame.png").read()
        nid = edit({"op": "add", "template": "Sphere", "pos": [50, 60]})["id"]
        edit({"op": "set_input", "id": nid, "name": "center",
              "value": [0.0, 1.6, 0.0]})
        edit({"op": "set_input", "id": nid, "name": "radius", "value": 0.6})
        g = json.loads(urllib.request.urlopen(url + "/graph").read())
        union = next(n for n in g["nodes"] if n["template"] == "Subtraction")
        root = next(n for n in g["nodes"] if n["template"] == "Root")
        u2 = edit({"op": "add", "template": "Union"})["id"]
        edit({"op": "connect", "src": union["id"], "dst": u2, "input": "A"})
        edit({"op": "connect", "src": nid, "dst": u2, "input": "B"})
        edit({"op": "connect", "src": u2, "dst": root["id"], "input": "SDF"})
        png1 = urllib.request.urlopen(url + "/frame.png").read()
        assert png0 != png1  # the added sphere is visible

        # positions persist and travel with the graph
        edit({"op": "move", "id": nid, "pos": [123, 45]})
        g2 = json.loads(urllib.request.urlopen(url + "/graph").read())
        assert g2["pos"][str(nid)] == [123, 45]

        # disconnect + remove restore the old image
        edit({"op": "disconnect", "dst": root["id"], "input": "SDF"})
        edit({"op": "connect", "src": union["id"], "dst": root["id"],
              "input": "SDF"})
        edit({"op": "remove", "id": u2})
        edit({"op": "remove", "id": nid})
        png2 = urllib.request.urlopen(url + "/frame.png").read()
        assert png2 == png0

    def test_bad_edit_returns_400(self, server):
        url, app = server
        for op in (
            {"op": "frobnicate"},
            {"op": "add", "template": "Blob"},
            {"op": "connect", "src": 999, "dst": 998, "input": "A"},
        ):
            req = urllib.request.Request(
                url + "/edit", data=json.dumps(op).encode()
            )
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req)
            assert e.value.code == 400


class TestMaterialEditing:
    def test_painted_material_edit_end_to_end(self):
        """Insert a Material node between the scene and Root via the edit
        API, render, and verify the painted albedo shows in the image;
        then CHANGE the albedo value — a pure buffer swap (dynamic tape:
        zero recompiles) that recolors the object."""
        app = ViewerApp(width=W, height=H, cfg=CFG, backend="jnp", device="cpu")
        img0 = app.frame()

        g = app.graph_dict()
        root = next(n for n in g["nodes"] if n["template"] == "Root")
        old_sdf = dict(root["inputs"]["SDF"])
        mid = app.edit({"op": "add", "template": "Material"})["id"]
        app.edit({"op": "connect", "src": old_sdf["$node"], "dst": mid,
                  "input": "A"})
        app.edit({"op": "set_input", "id": mid, "name": "albedo",
                  "value": [0.9, 0.1, 0.1]})
        rid = next(n["id"] for n in g["nodes"] if n["template"] == "Root")
        app.edit({"op": "connect", "src": mid, "dst": rid, "input": "SDF"})

        img_red = app.frame()
        # The scene recolors: red channel dominance flips vs the default
        # green-ish albedo on object pixels.
        obj = np.abs(img_red - img0).max(-1) > 1e-3
        assert obj.mean() > 0.02  # the repaint is visible
        reds = img_red[..., 0] - img_red[..., 1]
        assert (reds[obj] > 0.05).mean() > 0.5  # painted red wins

        # Albedo VALUE edit: same spec (has_materials already true) ->
        # zero recompiles, image changes to blue.
        compiles0 = app.compiles
        app.edit({"op": "set_input", "id": mid, "name": "albedo",
                  "value": [0.1, 0.1, 0.9]})
        img_blue = app.frame()
        assert app.compiles == compiles0
        blues = img_blue[..., 2] - img_blue[..., 0]
        assert (blues[obj] > 0.05).mean() > 0.5

    def test_state_reports_tier_telemetry(self):
        app = ViewerApp(width=W, height=H, cfg=CFG, backend="jnp", device="cpu")
        st = app.state()
        assert st["tier"] == "single"  # jnp backend: single-tier path
        app2 = ViewerApp(
            width=W, height=H, cfg=CFG, backend="pallas_prepass", tiered=True, device="cpu"
        )
        # Tiered apps surface runtime.TieredRenderer.stats() telemetry.
        st2 = app2.state()
        assert "tiered" in st2
        for key in (
            "frames", "dynamic_frames", "static_compiles", "static_cached",
            "pending_compiles", "last_tier",
        ):
            assert key in st2["tiered"]


class TestPort:
    def test_default_device_is_the_card(self):
        """Every entry point defaults to the card: without a GPU the app
        raises naming CUDA, and never renders on the CPU."""
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: this checks the machine without one")
        with pytest.raises(RuntimeError, match="CUDA"):
            ViewerApp(width=W, height=H, cfg=CFG)
        app = ViewerApp(width=W, height=H, cfg=CFG, device="cpu")
        assert app.backend == "jnp" and app.state()["tier"] == "single"

    def test_kernel_backend_serves_tiers_on_the_cpu(self):
        """The card's default, backend "pallas_prepass" through the tiered
        runtime, with the kernels' plain versions: the first frame comes
        from the dynamic tier, then the static tier serves; an edit that
        adds a node stays in the dynamic bucket and shows at once."""
        cfg = rt.RenderConfig(aa_samples=1, max_iter=48, bound_accel=True, exit_check_every=4)
        app = ViewerApp(width=W, height=H, cfg=cfg, backend="pallas_prepass", device="cpu")
        img0 = app.frame()
        assert app.state()["tier"] == "dynamic" and np.isfinite(img0).all()
        assert app._tiered.wait(timeout=120.0)
        img1 = app.frame()
        assert app.state()["tier"] == "static"
        assert np.abs(img0 - img1).mean() < 5e-4
        dynamic = dict(app._tiered._dynamic)
        nid = app.edit({"op": "add", "template": "Sphere"})["id"]
        app.edit({"op": "set_input", "id": nid, "name": "center", "value": [0.0, 1.6, 0.0]})
        app.edit({"op": "set_input", "id": nid, "name": "radius", "value": 0.5})
        g = app.graph_dict()
        root = next(n for n in g["nodes"] if n["template"] == "Root")
        u = app.edit({"op": "add", "template": "Union"})["id"]
        app.edit({"op": "connect", "src": root["inputs"]["SDF"]["$node"], "dst": u, "input": "A"})
        app.edit({"op": "connect", "src": nid, "dst": u, "input": "B"})
        app.edit({"op": "connect", "src": u, "dst": root["id"], "input": "SDF"})
        img2 = app.frame()
        assert app.state()["tier"] == "dynamic" and app._tiered._dynamic == dynamic
        assert np.abs(img2 - img1).max() > 1e-3
        assert app._tiered.wait(timeout=120.0)

    def test_main_parses_the_command_line(self, monkeypatch):
        """`python -m raymarch_tpu_torch.viewer --cpu --size 32x18 --aa 3
        --port 0` builds a CPU app on the "jnp" backend and serves it."""
        seen = {}

        def fake_serve(app, port=8000, host="127.0.0.1"):
            seen.update(app=app, port=port)

        import raymarch_tpu_torch.viewer as viewer

        monkeypatch.setattr(viewer, "serve", fake_serve)
        monkeypatch.setattr(viewer.ViewerApp, "prewarm", lambda self: None)
        main(["--cpu", "--size", "32x18", "--aa", "3", "--port", "0"])
        a = seen["app"]
        assert (a.width, a.height, a.cfg.aa_samples, a.backend, a.device.type) == (32, 18, 3, "jnp", "cpu")
        assert seen["port"] == 0
