"""The port's routing plane: predictors, the dual solver, the router, the
shared control loop, the health plane and the serving simulator."""
from .baselines import (BalanceAware, Oracle, PerceptionOnly, Policy,
                        RandomPolicy, RouteBatch, S3Cost, pad_batch,
                        pad_bucket)
from .control import (AdaptiveWindow, AdmissionRule, ControlLoop, FoldBuffer,
                      StreamController)
from .features import FEAT_LEN, featurize_tokens, predicted_cost, projection
from .health import HealthConfig, HealthTracker
from .hybrid import HybridConfig, HybridPredictor, hybrid_predict_device
from .optimizer import (DualSolver, DualState, SolveInfo, brute_force,
                        budget_polish, fold_threshold, init_dual_state,
                        primal_polish, repair_workload, solve_assignment,
                        solve_budget)
from .predictor import (PredictorConfig, PredictorNet, TrainedPredictor,
                        encode_queries, loss_fn, predict,
                        trained_predict_device)
from .retrieval import (RetrievalPredictor, VectorStore, cosine_topk,
                        retrieval_predict_device)
from .router import OmniRouter, RouterConfig, evaluate_assignment
from .scheduler import (SchedulerConfig, ServeResult, fold_completions,
                        route_via_batch, run_serving)

__all__ = [
    "AdaptiveWindow", "AdmissionRule", "BalanceAware", "ControlLoop",
    "DualSolver", "DualState", "FEAT_LEN", "FoldBuffer", "HealthConfig",
    "HealthTracker", "HybridConfig", "HybridPredictor", "OmniRouter", "Oracle",
    "PerceptionOnly", "Policy", "PredictorConfig", "PredictorNet",
    "RandomPolicy", "RetrievalPredictor", "RouteBatch", "RouterConfig",
    "S3Cost", "SchedulerConfig", "ServeResult", "SolveInfo",
    "StreamController", "TrainedPredictor", "VectorStore", "brute_force",
    "budget_polish", "cosine_topk", "encode_queries", "evaluate_assignment",
    "featurize_tokens", "fold_completions", "fold_threshold",
    "hybrid_predict_device", "init_dual_state", "loss_fn", "pad_batch",
    "pad_bucket", "predict", "predicted_cost", "primal_polish", "projection",
    "repair_workload", "retrieval_predict_device", "route_via_batch",
    "run_serving", "solve_assignment", "solve_budget",
    "trained_predict_device",
]
