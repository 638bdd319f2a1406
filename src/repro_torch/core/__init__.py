"""The exit decision (confidence, policy), calibration, MAC accounting, the
staged cascade executor and the cascade's training losses; the names the
JAX package's ``repro.core`` exports."""
from repro_torch.core.confidence import (entropy_confidence,
                                         softmax_confidence, softmax_outputs)
from repro_torch.core.calibration import (accuracy_vs_confidence,
                                          calibrate_thresholds,
                                          CalibrationResult,
                                          threshold_for_epsilon)
from repro_torch.core.policy import (BudgetPolicy, Calibrator,
                                     ConfidenceMeasure, ExitDecider,
                                     ExitDecision, ExitPolicy,
                                     ThresholdPolicy, available_calibrators,
                                     available_measures, available_policies,
                                     get_calibrator, get_measure, get_policy,
                                     register_calibrator, register_measure,
                                     register_policy)
from repro_torch.core.cascade import (cascade_evaluate,
                                      cascade_infer_sequential,
                                      CascadeEvalResult, sweep_epsilons)
from repro_torch.core.exec import (DecodeState, StagedExecutor,
                                   init_decode_state)
from repro_torch.core.training import (backtrack_training_plan, cascade_loss,
                                       trainability_mask)

__all__ = [
    "softmax_confidence", "softmax_outputs", "entropy_confidence",
    "calibrate_thresholds", "accuracy_vs_confidence", "CalibrationResult",
    "threshold_for_epsilon",
    "ConfidenceMeasure", "ExitPolicy", "ThresholdPolicy", "BudgetPolicy",
    "Calibrator", "ExitDecider", "ExitDecision",
    "get_measure", "get_policy", "get_calibrator",
    "register_measure", "register_policy", "register_calibrator",
    "available_measures", "available_policies", "available_calibrators",
    "cascade_evaluate", "cascade_infer_sequential", "CascadeEvalResult",
    "sweep_epsilons",
    "DecodeState", "StagedExecutor", "init_decode_state",
    "backtrack_training_plan", "cascade_loss", "trainability_mask",
]
