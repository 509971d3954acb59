from .cost_fn import (MIN_X, SceneArrays, SceneMeta, build_scene,
                      make_cost_fn, make_prior_fn, make_total_od_fn)
from .solver import (MinimizerStatus, SolveResult, TrainingCost, solve,
                     log_state_tree, state_bounds)
