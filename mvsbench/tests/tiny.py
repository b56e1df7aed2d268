"""A cell cut to a size the CPU runs in seconds, for the tests.

The final cloud's limits are the tiny size's own, set from its readings
on the CPU over 12 seeds (the cell's limits files hold those of the
timed size): on the plane, the program reads acc_p90 0.0205-0.0256,
comp_pct 42.0-47.5 and growth 2.58-2.77; a propagation left unchanged
comp_pct 2.5-15.2 and growth 0.11-0.48; half of the hypotheses left out
growth 1.53-1.75. On the sphere, the program reads acc_p90 0.0101-0.0134,
comp_pct 14.3-21.8 and growth 0.99-1.44, and a propagation left
unchanged comp_pct 0-6.3 and growth 0-0.32.
"""

import copy

from mvsbench import run

CLOUD_LIMITS = {
    "dino16.plane": {"acc_p90": {"max": 0.04}, "comp_pct": {"min": 25.0},
                     "growth": {"min": 2.15}},
    "dino16.sphere2": {"acc_p90": {"max": 0.03}, "comp_pct": {"min": 9.0},
                       "growth": {"min": 0.6}},
}


def tiny_cell(name: str = "dino16.plane") -> dict:
    cell = copy.deepcopy(run.load_cell(name))
    cell["config"].update(views=6, width=160, height=120, seed_points=256)
    cell["config"]["engine"].update(n_iterations=1, prop_rounds=1, max_patches=4096,
                                    donor_budget=256, gauntlet_chunk=256, refine_cands=4,
                                    use_pallas=False)
    cell["limits"].update(CLOUD_LIMITS[name])
    return cell
