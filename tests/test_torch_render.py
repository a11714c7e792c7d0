"""The port's renderer against the JAX package's.

* The ``init`` and ``update`` payloads are equal for the same inputs.
* A replay of ANM6Easy (same seed, same actions, 4 frames) through both
  packages' ``write_replay``: the HTML is equal outside the embedded data,
  the data's numbers agree to 1e-8, and the frames give the same rendered
  attributes (``tests/test_replay_artifact.py``'s Python mirror of app.js).
* ``write_replay`` before ``render`` raises; a live render boots the
  servers, a WebSocket listener receives the ``init`` and an ``update``
  frame, ``close()`` stops both servers, and the only file the port's
  renderer writes is its own ``web/index.html``, never the JAX package's.

The copies' checks (modules, client files, the pinned ``frameAttrs``) are
in ``tests/test_torch_gym_surface.py``; this file keeps few tests so that
it runs after the suite's long-running files have started (see
``tests/test_torch_gym_env.py``).
"""

import datetime as dt
import json
import os
import re
from unittest import mock

import numpy as np
import pytest

from gym_anm_tpu.envs.anm6.anm6_easy import ANM6Easy as JaxANM6Easy
from gym_anm_tpu.render import rendering as jax_rendering

from gym_anm_tpu_torch.envs.anm6.anm6_easy import ANM6Easy
from gym_anm_tpu_torch.render import rendering
from tests import test_replay_artifact as artifact


ATOL = 1e-8
# Blocking socket calls of the live test carry this deadline (seconds; see
# tests/test_render_servers.py on why no timeout mark is used).
DEADLINE = 60


def test_payloads_equal_jax():
    rng = np.random.default_rng(0)
    topo = {"busOfDevice": [0, 1, 1], "branches": [[0, 1]], "slackBus": 0}
    init_args = ("T", [0, -1, 2], rng.uniform(size=3), rng.uniform(size=3), rng.uniform(size=1), [0.9, 0.9],
                 [1.1, 1.1], [5.0], (1, 100))
    for topology in (None, topo):
        assert rendering.init_payload(*init_args, topology) == jax_rendering.init_payload(*init_args, topology)
    upd = (dt.datetime(2020, 3, 4, 5, 45), 1, rng.normal(size=3), rng.normal(size=3), rng.normal(size=1),
           [2.5], [7.0], [1.0, 0.97], [0.1, 2.0], False)
    assert rendering.update_payload(*upd) == jax_rendering.update_payload(*upd)


def _replay_html(env, tmp_path, name, actions):
    env.reset(seed=0)
    env.render(mode="replay")
    for a in actions:
        env.step(a)
        env.render()
    path = env.write_replay(str(tmp_path / name))
    env.close()
    with open(path) as f:
        return f.read()


def _split(html):
    m = re.search(r"var REPLAY = (\{.*?\});</script>", html, re.S)
    assert m, "embedded replay data not found"
    return html[: m.start(1)], json.loads(m.group(1).replace("<\\/", "</")), html[m.end(1):]


def _assert_close(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            _assert_close(a[k], b[k], "%s/%s" % (path, k))
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_close(x, y, "%s[%d]" % (path, i))
    elif isinstance(a, float):
        assert isinstance(b, float) and abs(a - b) <= ATOL, (path, a, b)
    else:
        assert a == b and type(a) is type(b), (path, a, b)


def test_replay_matches_jax(tmp_path):
    env = ANM6Easy(device="cpu")
    rng = np.random.default_rng(1)
    actions = [rng.uniform(env.action_space.low, env.action_space.high) for _ in range(3)]
    html = _replay_html(env, tmp_path, "port.html", actions)
    jhtml = _replay_html(JaxANM6Easy(), tmp_path, "jax.html", actions)
    (head, data, tail), (jhead, jdata, jtail) = _split(html), _split(jhtml)
    assert head == jhead and tail == jtail
    assert "setupReplay(REPLAY)" in tail and "<script src=" not in html
    assert len(data["frames"]) == 4
    _assert_close(data, jdata)
    scene = artifact.build_scene_py(data["init"])
    artifact.assert_scene_well_laid_out(data["init"])
    for fr, jfr in zip(data["frames"], jdata["frames"]):
        assert not fr["networkCollapsed"]
        _assert_close(artifact.frame_attrs_py(data["init"], scene, fr), artifact.frame_attrs_py(jdata["init"], scene, jfr))


def test_write_replay_requires_recording(tmp_path):
    env = ANM6Easy(device="cpu")
    env.reset(seed=0)
    with pytest.raises(RuntimeError, match="no recorded frames"):
        env.write_replay(str(tmp_path / "none.html"))
    env.close()
    assert not (tmp_path / "none.html").exists()


def test_live_render_and_close(monkeypatch):
    websocket = pytest.importorskip("websocket")
    port_index = os.path.join(rendering.WEB_FOLDER, "index.html")
    with open(port_index, "rb") as f:
        port_before = f.read()
    # The files the port's renderer opens for writing (the JAX package's own
    # render tests may rewrite its index.html concurrently, so its content
    # cannot be compared before and after).
    written = []

    def spy_open(path, mode="r", *args, **kwargs):
        if any(c in mode for c in "wax+"):
            written.append(os.path.abspath(path))
        return open(path, mode, *args, **kwargs)

    monkeypatch.setattr(rendering, "open", spy_open, raising=False)
    env = ANM6Easy(device="cpu")
    env.reset(seed=4)
    try:
        with mock.patch("webbrowser.open") as opened:
            env.render()
        opened.assert_called_once_with(env.http_server.address + "/")
        assert written == [port_index]
        assert not any(p.startswith(jax_rendering.WEB_FOLDER) for p in written)
        with open(port_index) as f:
            assert 'wsServerAddress = "%s"' % env.ws_server.address in f.read()
        ws = websocket.create_connection(env.ws_server.address, timeout=DEADLINE)
        try:
            init = json.loads(ws.recv())
            assert init["messageLabel"] == "init" and init["title"] == "ANM6Easy"
            assert init["deviceType"] == [0, -1, 2, -1, 2, -1, 3]
            assert init["topology"]["branches"] == [[0, 1], [1, 2], [1, 3], [2, 4], [2, 5]]
            env.step(np.zeros(env.action_space.shape))
            env.render()
            upd = json.loads(ws.recv())
            assert upd["messageLabel"] == "update" and len(upd["vMagn"]) == 6
            np.testing.assert_allclose(upd["pInjections"], list(env.simulator.state["dev_p"]["MW"].values()),
                                       rtol=1e-12)
        finally:
            ws.close()
    finally:
        env.close()
        with open(port_index, "wb") as f:
            f.write(port_before)
    for proc in (env.http_server.process, env.ws_server.process):
        proc.join(timeout=DEADLINE)
        assert not proc.is_alive()
    assert env.render_mode is None
    assert written == [port_index]
