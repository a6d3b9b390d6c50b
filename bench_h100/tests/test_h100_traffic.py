"""The traffic generator: one seed gives the same states, another seed
states of its own at other times in the shot, a state is the scene's
velocity after the step's gravity, the sag cycle turns the beam as stated,
and the frozen scenes equal the program's."""

import math

import pytest
import torch

from _h100 import run  # noqa: F401  (the harness's path)
import frames

BEAM = {"scene": "beam", "n": 32, "dtype": "float32", "viscosity": 5.0, "density": 1.0,
        "dt": 1 / 24}
STEADY = run.load_json(run.HERE / "traffic" / "steady.json")
SAG = run.load_json(run.HERE / "traffic" / "sag.json")


def _equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in ("liquid_sdf", "solid_sdf", "viscosity",
                                                  "density")) and \
        all(torch.equal(x, y) for x, y in zip(a["velocity"], b["velocity"]))


@pytest.mark.parametrize("traffic", [STEADY, SAG], ids=["steady", "sag"])
def test_same_seed_same_states_other_seed_other_states(traffic):
    a = frames.make_states(BEAM, traffic, 2**31 + 11, "cpu")
    b = frames.make_states(BEAM, traffic, 2**31 + 11, "cpu")
    assert len(a) == traffic["states"]
    assert all(_equal(x, y) for x, y in zip(a, b))
    # the states of one cycle differ from each other
    assert not torch.equal(a[0]["velocity"][1], a[1]["velocity"][1])
    c = frames.make_states(BEAM, traffic, 12, "cpu")
    assert all(torch.equal(x["liquid_sdf"], y["liquid_sdf"]) for x, y in zip(a, c))
    assert not any(torch.equal(x["velocity"][1], y["velocity"][1]) for x, y in zip(a, c))
    starts = [frames.start_frame(traffic, s) for s in (2**31 + 11, 12, 5, 3 * 2**31)]
    lo, hi = traffic["start"]
    assert len(set(starts)) == 4 and all(lo <= t <= hi for t in starts)


@pytest.mark.parametrize("scene", ["beam", "buckling"])
def test_a_state_is_the_scene_after_the_steps_gravity(scene):
    config = dict(BEAM, scene=scene)
    seed = 2**31 + 5
    states = frames.make_states(config, STEADY, seed, "cpu")
    _, _, vel = frames.SCENES[scene](32, "cpu")
    t0 = frames.start_frame(STEADY, seed)
    dt = float(torch.tensor(BEAM["dt"], dtype=torch.float32))
    for i, s in enumerate(states):
        fall = STEADY["gravity"] * dt * (t0 + i)
        assert torch.equal(s["velocity"][0], vel[0].float())
        assert torch.equal(s["velocity"][2], vel[2].float())
        assert torch.allclose(s["velocity"][1].double(), vel[1] + fall, rtol=0, atol=1e-6)
    # one frame of gravity between neighbouring states: 9.8 / 24 m/s
    gap = float((states[1]["velocity"][1].double() - states[0]["velocity"][1].double()).mean())
    assert abs(gap + 9.8 / 24) < 1e-5


def test_sag_turns_the_beam_down_about_its_anchor():
    n = 64
    states = frames.make_states(dict(BEAM, n=n), SAG, 3, "cpu")
    lo, hi = SAG["rotate"]["degrees"]
    px, py = SAG["rotate"]["pivot"]
    assert len(states) == 12
    # points of the unturned beam (box x 0.05-0.65, y 0.55-0.75, z 0.35-0.65)
    # and their distance to its surface: the axis midpoint, the free end's
    # centre, a point of the lower face
    points = [((0.35, 0.65), -0.10), ((0.65, 0.65), 0.0), ((0.45, 0.55), 0.0)]
    for k, s in enumerate(states):
        a = math.radians(lo + (hi - lo) * k / (len(states) - 1))
        for (x, y), want in points:
            # turned clockwise (downward) by a about the pivot
            tx = px + math.cos(a) * (x - px) + math.sin(a) * (y - py)
            ty = py - math.sin(a) * (x - px) + math.cos(a) * (y - py)
            got = float(s["liquid_sdf"][int(tx * n), int(ty * n), n // 2])
            assert abs(got - want) <= 1.5 / n, (k, (x, y), got, want)
    # the last state has left the unturned place: the old midpoint is near the surface
    last = states[-1]
    assert float(last["liquid_sdf"][int(0.35 * n), int(0.65 * n), n // 2]) > -0.05
    assert torch.equal(states[0]["liquid_sdf"], frames.make_states(
        dict(BEAM, n=n), STEADY, 3, "cpu")[0]["liquid_sdf"])


@pytest.mark.parametrize("scene", ["beam", "buckling"])
def test_frozen_scene_equals_the_programs(scene):
    from adaptiveviscositysolver_tpu_torch import scenes

    want = getattr(scenes, scene)(n=16, device="cpu")
    config = dict(BEAM, scene=scene, n=16, viscosity=want.viscosity.flatten()[0].item())
    (got,) = frames.make_states(config, {"states": 1, "gravity": -9.8, "start": [0.0, 0.0]}, 1, "cpu")
    for k in ("liquid_sdf", "solid_sdf", "viscosity", "density"):
        assert torch.equal(got[k], getattr(want, k)), k
    for a in range(3):
        assert torch.equal(got["velocity"][a], want.velocity[a])
        assert torch.equal(got["solid_velocity"][a], want.solid_velocity[a])
    assert got["dx"] == want.dx
