"""Offline replay recording: frame capture and the standalone HTML artifact."""

import json
import re

import numpy as np

from gym_anm_tpu.envs import ANM6Easy
import pytest


def test_replay_records_and_writes_standalone_html(tmp_path):
    env = ANM6Easy()
    env.reset(seed=0)
    env.render(mode="replay")  # first call records the initial frame
    for _ in range(4):
        env.step(np.zeros(env.action_space.shape, dtype=np.float64))
        env.render()
    path = env.write_replay(str(tmp_path / "episode.html"))
    env.close()

    with open(path) as f:
        html = f.read()

    # Self-contained: no external script/style references, no WebSocket use.
    assert "<script src=" not in html
    assert 'rel="stylesheet"' not in html

    m = re.search(r"var REPLAY = (\{.*?\});</script>", html, re.S)
    assert m, "embedded replay data not found"
    data = json.loads(m.group(1).replace("<\\/", "</"))
    assert data["init"]["messageLabel"] == "init"
    assert len(data["init"]["deviceType"]) == 7
    assert "topology" in data["init"]
    assert len(data["frames"]) == 5  # initial frame + 4 steps
    for fr in data["frames"]:
        assert fr["messageLabel"] == "update"
        assert len(fr["pInjections"]) == 7
        assert len(fr["vMagn"]) == 6
        assert not fr["networkCollapsed"]

    # The client dispatches into replay mode when REPLAY is defined.
    assert "setupReplay(REPLAY)" in html


def test_replay_requires_recording():
    env = ANM6Easy()
    env.reset(seed=0)
    try:
        env.write_replay("/tmp/should_not_exist.html")
        assert False, "expected RuntimeError"
    except RuntimeError:
        pass
    finally:
        env.close()


@pytest.mark.slow
def test_feeder_envs_render_replay(tmp_path):
    """Rendering is generic over topologies: the 33- and
    141-bus feeders record and write working replay artifacts too."""
    from gym_anm_tpu.envs import Feeder33Env
    from gym_anm_tpu.envs import Feeder141Env

    for cls, n_bus in ((Feeder33Env, 33), (Feeder141Env, 141)):
        env = cls()
        env.reset(seed=0)
        env.render(mode="replay")
        for _ in range(2):
            env.step(np.zeros(env.action_space.shape, dtype=np.float64))
            env.render()
        path = env.write_replay(str(tmp_path / f"episode_{n_bus}.html"))
        env.close()

        with open(path) as f:
            html = f.read()
        m = re.search(r"var REPLAY = (\{.*?\});</script>", html, re.S)
        assert m, "embedded replay data not found"
        data = json.loads(m.group(1).replace("<\\/", "</"))
        n_dev = env.simulator.spec.n_dev
        assert len(data["init"]["deviceType"]) == n_dev
        assert len(data["init"]["topology"]["busOfDevice"]) == n_dev
        assert len(data["frames"]) == 3
        for fr in data["frames"]:
            assert len(fr["vMagn"]) == n_bus
            assert not fr["networkCollapsed"]


def test_feeder_env_live_render_smoke():
    """Live-mode render on a non-ANM6 env boots the real HTTP/WS servers
    (headless: no browser opens) and close() tears them down."""
    from unittest import mock

    from gym_anm_tpu.envs import Feeder33Env

    env = Feeder33Env()
    env.reset(seed=0)
    with mock.patch("webbrowser.open"):
        env.render()  # human mode: boots servers, sends the init message
    env.step(np.zeros(env.action_space.shape, dtype=np.float64))
    env.render()
    assert env.is_rendering
    env.close()
    assert env.render_mode is None
