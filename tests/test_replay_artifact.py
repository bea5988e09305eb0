"""Rendered-scene verification for the replay artifact.

No browser/JS runtime exists in this environment, so the browser client's
deterministic tidy-tree layout (render/web/app.js:152-231 ``layout``) is
mirrored here in Python and run on the real topology payload: the test
asserts the structural properties a human checks in the picture -- every
bus placed at finite coordinates, busbars never overlapping, children
centered under parents, depth rows consistent -- for both envs and for the
committed feeder141 replay artifact (docs/assets/replay_feeder141.html).

The mirror follows the JS line by line (BFS tree from the slack, width =
max(own device row, packed children), leaves packed left-to-right), so a
layout regression in either language breaks the assertion.
"""

import json
import os
import re

import numpy as np
import pytest

ARTIFACT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "docs", "assets", "replay_feeder141.html"
)

DEV_W, BUS_MIN_W, GAP, LEVEL_H = 64, 56, 26, 168  # app.js:186-189


def layout_py(spec, topo):
    """Python mirror of app.js ``layout`` (app.js:152-231)."""
    n_bus = len(spec["vMagnMin"])
    devs_of_bus = [[] for _ in range(n_bus)]
    for d, b in enumerate(topo["busOfDevice"]):
        devs_of_bus[b].append(d)

    adj = [[] for _ in range(n_bus)]
    for k, (f, t) in enumerate(topo["branches"]):
        adj[f].append((t, k))
        adj[t].append((f, k))

    parent = [-1] * n_bus
    depth = [-1] * n_bus
    children = [[] for _ in range(n_bus)]
    order = []
    depth[topo["slackBus"]] = 0
    queue = [topo["slackBus"]]
    while queue:
        u = queue.pop(0)
        order.append(u)
        for v, k in adj[u]:
            if depth[v] == -1:
                depth[v] = depth[u] + 1
                parent[v] = u
                children[u].append(v)
                queue.append(v)

    width = [0.0] * n_bus
    for u in reversed(order):
        own = max(BUS_MIN_W, len(devs_of_bus[u]) * DEV_W)
        kids = sum(width[c] for c in children[u]) + GAP * max(0, len(children[u]) - 1)
        width[u] = max(own, kids)

    x = [0.0] * n_bus
    y = [0.0] * n_bus

    def place_at(u, left):
        x[u] = left + width[u] / 2
        y[u] = 64 + depth[u] * LEVEL_H
        cl = left + (width[u] - (sum(width[c] for c in children[u]) + GAP * max(0, len(children[u]) - 1))) / 2
        for c in children[u]:
            place_at(c, cl)
            cl += width[c] + GAP

    place_at(topo["slackBus"], 24)
    bus_w = lambda u: max(BUS_MIN_W, len(devs_of_bus[u]) * DEV_W)
    return {"x": x, "y": y, "depth": depth, "bus_w": bus_w, "parent": parent, "order": order}


def assert_scene_well_laid_out(init):
    topo = init["topology"]
    n_bus = len(init["vMagnMin"])
    n_branch = len(init["sRate"])
    assert len(topo["branches"]) == n_branch
    assert len(topo["busOfDevice"]) == len(init["deviceType"])

    L = layout_py(init, topo)
    xs, ys = np.asarray(L["x"]), np.asarray(L["y"])
    # Every bus placed, at finite coordinates (all buses reachable).
    assert len(L["order"]) == n_bus
    assert np.all(np.isfinite(xs)) and np.all(np.isfinite(ys))
    # No overlapping busbars within a depth row (the layout's guarantee).
    rows = {}
    for u in range(n_bus):
        rows.setdefault(L["depth"][u], []).append(u)
    for row in rows.values():
        spans = sorted((xs[u] - L["bus_w"](u) / 2, xs[u] + L["bus_w"](u) / 2) for u in row)
        for (l1, r1), (l2, r2) in zip(spans, spans[1:]):
            assert r1 <= l2 + 1e-9, "overlapping busbars in one depth row"
    # Every branch connects buses exactly one visual level apart for tree
    # edges (BFS tree on a radial network = every edge).
    for f, t in topo["branches"]:
        assert abs(L["depth"][f] - L["depth"][t]) >= 1 or f == t


def test_feeder141_layout_structure():
    """Layout assertions on the live feeder141 init payload (independent of
    the committed artifact)."""
    from gym_anm_tpu.envs import Feeder141Env

    env = Feeder141Env(seed=0)
    env.reset(seed=0)
    env.render(mode="replay")
    init = env.recorder.init
    assert_scene_well_laid_out(init)
    env.close()


def test_committed_replay_artifact():
    """The committed feeder141 replay HTML: parses, data block well-formed,
    every frame finite, and the scene it encodes lays out cleanly."""
    if not os.path.exists(ARTIFACT):
        pytest.fail("docs/assets/replay_feeder141.html missing -- regenerate with "
                    "scripts/gen_replay_artifact.py")
    with open(ARTIFACT) as f:
        html = f.read()
    m = re.search(r"<script>var REPLAY = (.*?);</script>", html, re.S)
    assert m, "embedded REPLAY data block not found"
    data = json.loads(m.group(1).replace("<\\/", "</"))
    init, frames = data["init"], data["frames"]
    assert len(frames) >= 10
    n_dev = len(init["deviceType"])
    n_bus = len(init["vMagnMin"])
    for fr in frames:
        for key, n in (("pInjections", n_dev), ("qInjections", n_dev), ("vMagn", n_bus)):
            v = np.asarray(fr[key], dtype=float)
            assert v.shape == (n,) and np.all(np.isfinite(v)), key
        assert isinstance(fr["networkCollapsed"], (bool, int))
    assert_scene_well_laid_out(init)


# ---------------------------------------------------------------------------
# Update-path verification: app.js's frame
# application is a PURE function `frameAttrs(spec, scene, msg)` whose source
# is pinned byte-for-byte below and mirrored line-by-line in Python here.
# No JS engine exists in this environment (no node/browser binary), so the
# lockstep guarantee is: any edit to the JS update logic changes the pinned
# bytes and fails test_frame_attrs_source_pinned, forcing the mirror (and
# these semantic assertions over the committed replay payload) to be
# updated with it.
# ---------------------------------------------------------------------------

APP_JS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "gym_anm_tpu", "render", "web", "app.js",
)
PINNED = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "frame_attrs_pinned.js")

COL = {  # app.js COL entries the update path uses
    "bus": "#2c3e50", "busBad": "#e74c3c", "text": "#2c3e50",
    "pPos": "#27ae60", "pNeg": "#c0392b",
}


def extract_frame_attrs_src():
    src = open(APP_JS).read()
    i = src.index("function frameAttrs(")
    depth, j = 0, i
    while True:
        c = src[j]
        if c == "{":
            depth += 1
        elif c == "}":
            depth -= 1
            if depth == 0:
                break
        j += 1
    return src[i : j + 1]


def test_frame_attrs_source_pinned():
    """The JS update path must match the committed pinned copy: editing
    app.js's frameAttrs without updating tests/data/frame_attrs_pinned.js
    AND the Python mirror below is a suite failure by construction."""
    assert extract_frame_attrs_src() == open(PINNED).read().rstrip("\n"), (
        "render/web/app.js frameAttrs() changed: update the Python mirror "
        "frame_attrs_py in this file to match, then re-pin with "
        "tests/data/frame_attrs_pinned.js"
    )


def _js_round(x):
    """JS Math.round (half away from zero toward +inf)."""
    import math

    return math.floor(x + 0.5)


def load_color_py(frac):
    if not np.isfinite(frac):
        frac = 0.0
    f = max(0.0, min(1.0, frac))
    r = _js_round(46 + f * (231 - 46))
    g = _js_round(204 - f * (204 - 76))
    b = _js_round(113 - f * (113 - 60))
    return f"rgb({r},{g},{b})"


def build_scene_py(init):
    """Mirror of buildScene's device-geometry construction (app.js:353-383):
    device order, gauge geometry, genIndex/socIndex maps."""
    topo = init["topology"]
    L = layout_py(init, topo)
    n_bus = len(init["vMagnMin"])
    devs_of_bus = [[] for _ in range(n_bus)]
    for d, b in enumerate(topo["busOfDevice"]):
        devs_of_bus[b].append(d)
    devices = []
    for i in range(n_bus):
        devs = devs_of_bus[i]
        for j, d in enumerate(devs):
            cx = L["x"][i] - (len(devs) * DEV_W) / 2 + DEV_W * (j + 0.5)
            t = init["deviceType"][d]
            icon_y = L["y"][i] + 42
            devices.append(
                dict(d=d, type=t, cx=cx, gw=48, gy=icon_y + 30, iconY=icon_y,
                     potTick=t in (1, 2), socFill=t == 3)
            )
    gi = si = 0
    gen_index, soc_index = {}, {}
    for d, t in enumerate(init["deviceType"]):
        if t in (1, 2):
            gen_index[d] = gi
            gi += 1
        if t == 3:
            soc_index[d] = si
            si += 1
    return dict(devices=devices, genIndex=gen_index, socIndex=soc_index)


def frame_attrs_py(spec, scene, msg):
    """Line-by-line Python mirror of app.js frameAttrs (the pinned copy)."""
    out = {"branches": [], "buses": [], "devices": [], "reward": None, "clock": None}

    for k, s in enumerate(msg["sFlows"]):
        mag = abs(s)
        rate = spec["sRate"][k]
        finite = np.isfinite(rate)
        frac = mag / rate if (rate > 0 and finite) else 0.0
        out["branches"].append(
            dict(
                stroke=load_color_py(frac),
                strokeWidth=4.5 if frac > 1 else 3,
                label=f"{mag:.1f}/{rate:.0f} MVA" if finite else f"{mag:.1f} MVA",
                dir=1 if s >= 0 else -1,
                speed=min(3.0, 0.4 + 2.6 * frac),
            )
        )

    for i, v in enumerate(msg["vMagn"]):
        bad = v < spec["vMagnMin"][i] - 1e-9 or v > spec["vMagnMax"][i] + 1e-9
        out["buses"].append(
            dict(
                fill=COL["busBad"] if bad else COL["bus"],
                text=f"{v:.3f} pu",
                textFill=COL["busBad"] if bad else COL["text"],
            )
        )

    for dv in scene["devices"]:
        p = msg["pInjections"][dv["d"]]
        q = msg["qInjections"][dv["d"]]
        pmax = spec["pMax"][dv["d"]]
        frac = max(-1.0, min(1.0, p / pmax)) if (pmax > 0 and np.isfinite(pmax)) else 0.0
        w = abs(frac) * dv["gw"] / 2
        a = dict(
            d=dv["d"],
            barX=dv["cx"] if frac >= 0 else dv["cx"] - w,
            barW=w,
            barFill=COL["pPos"] if frac >= 0 else COL["pNeg"],
            label=f"{p:.1f} MW / {q:.1f} MVAr",
            pot=None,
            soc=None,
        )
        if dv["potTick"] and dv["type"] == 2:
            pot = msg["pPotential"][scene["genIndex"][dv["d"]]]
            if np.isfinite(pot) and pmax > 0:
                px = dv["cx"] + max(-1.0, min(1.0, pot / pmax)) * dv["gw"] / 2
                a["pot"] = dict(x=px, visible=True)
            else:
                a["pot"] = dict(x=dv["cx"], visible=False)
        elif dv["potTick"]:
            a["pot"] = dict(x=dv["cx"], visible=False)
        if dv["socFill"]:
            soc = msg["socStorage"][scene["socIndex"][dv["d"]]]
            max_soc = spec["socMax"][scene["socIndex"][dv["d"]]]
            f = max(0.0, min(1.0, soc / max_soc)) if max_soc > 0 else 0.0
            h = 18 * f
            a["soc"] = dict(height=h, y=dv["iconY"] + 9 - h)
        out["devices"].append(a)

    eloss, penalty = msg["reward"]
    out["reward"] = dict(
        elossPct=min(100.0, 100 * abs(eloss) / spec["energyLossMax"]),
        penaltyPct=min(100.0, 100 * penalty / spec["penaltyMax"]),
        elossText=f"{eloss:.3f}",
        penaltyText=f"{penalty:.3f}",
        collapsed=bool(msg["networkCollapsed"]),
    )

    month, day, hour, minute = msg["time"]
    clock = f"{day:02d}/{month:02d} {hour:02d}:{minute:02d}"
    if msg["yearCount"] > 0:
        clock += f"  (+{msg['yearCount']}y)"
    out["clock"] = clock
    return out


def test_frame_attrs_on_committed_artifact():
    """Run the mirrored update path over EVERY frame of the committed
    feeder141 replay and assert the rendered-attribute semantics a human
    checks in the moving picture: finite geometry inside the gauges,
    loading colors that saturate to red exactly when a branch exceeds its
    rating, voltage readouts flagged red exactly when out of bounds, SoC
    fills inside the battery shell, labels matching the frame values."""
    with open(ARTIFACT) as f:
        html = f.read()
    m = re.search(r"<script>var REPLAY = (.*?);</script>", html, re.S)
    data = json.loads(m.group(1).replace("<\\/", "</"))
    init, frames = data["init"], data["frames"]
    scene = build_scene_py(init)
    assert len(scene["devices"]) == len(init["deviceType"])

    for fr in frames:
        fa = frame_attrs_py(init, scene, fr)
        assert len(fa["branches"]) == len(init["sRate"])
        for k, a in enumerate(fa["branches"]):
            assert re.fullmatch(r"rgb\(\d+,\d+,\d+\)", a["stroke"])
            rate = init["sRate"][k]
            over = np.isfinite(rate) and rate > 0 and abs(fr["sFlows"][k]) > rate
            # Overloaded branches render thick and fully red.
            assert (a["strokeWidth"] == 4.5) == over
            if over:
                assert a["stroke"] == "rgb(231,76,60)"
            assert a["label"].endswith("MVA")
            assert 0.4 <= a["speed"] <= 3.0

        for i, a in enumerate(fa["buses"]):
            v = fr["vMagn"][i]
            bad = v < init["vMagnMin"][i] - 1e-9 or v > init["vMagnMax"][i] + 1e-9
            assert (a["fill"] == COL["busBad"]) == bad
            assert a["text"] == f"{v:.3f} pu"

        for a, dv in zip(fa["devices"], scene["devices"]):
            # P bar stays inside its gauge.
            assert 0.0 <= a["barW"] <= dv["gw"] / 2 + 1e-9
            assert dv["cx"] - dv["gw"] / 2 - 1e-9 <= a["barX"] <= dv["cx"] + dv["gw"] / 2 + 1e-9
            p = fr["pInjections"][dv["d"]]
            assert (a["barFill"] == COL["pPos"]) == (
                p >= 0 or not (init["pMax"][dv["d"]] > 0 and np.isfinite(init["pMax"][dv["d"]]))
            )
            if a["pot"] is not None and a["pot"]["visible"]:
                assert dv["cx"] - dv["gw"] / 2 - 1e-9 <= a["pot"]["x"] <= dv["cx"] + dv["gw"] / 2 + 1e-9
            if a["soc"] is not None:
                assert 0.0 <= a["soc"]["height"] <= 18.0 + 1e-9
                # Fill bottom anchored to the shell bottom, growing upward.
                assert abs((a["soc"]["y"] + a["soc"]["height"]) - (dv["iconY"] + 9)) < 1e-9

        assert 0.0 <= fa["reward"]["elossPct"] <= 100.0
        assert 0.0 <= fa["reward"]["penaltyPct"] <= 100.0
        assert fa["reward"]["collapsed"] == bool(fr["networkCollapsed"])
        assert re.fullmatch(r"\d\d/\d\d \d\d:\d\d(  \(\+\d+y\))?", fa["clock"])
