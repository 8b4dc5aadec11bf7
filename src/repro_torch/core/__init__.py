"""Core DSML library of the port: Algorithm 1 for regression and its
Section-4 logistic extension."""
from repro_torch.core.debias import coherence, debias_lasso, inverse_hessian_m
from repro_torch.core.dsml import DsmlResult, dsml_fit
from repro_torch.core.engine import (
    debias_batched,
    inverse_hessian_batched,
    power_iteration_batched,
    scaled_identity_m0,
    solve_lasso_batched,
    solve_lasso_eq2,
    solve_logistic_lasso_batched,
    sufficient_stats,
)
from repro_torch.core.logistic import (
    DsmlLogisticResult,
    debias_logistic,
    debias_logistic_batched,
    dsml_logistic_fit,
    group_logistic_lasso,
    icap_logistic,
    logistic_lasso,
    refit_logistic_masked,
)
from repro_torch.core.metrics import (
    classification_error,
    estimation_error,
    hamming,
    prediction_error,
    support_of,
)
from repro_torch.core.prox import (
    group_hard_threshold,
    group_soft_threshold,
    project_l1_ball,
    prox_linf,
    soft_threshold,
    support_from_rows,
)
from repro_torch.core.solvers import (
    fista,
    lasso,
    lasso_stats_step_scale,
    power_iteration,
    refit_ols_masked,
    refit_ols_masked_stats,
)
from repro_torch.core.synth import (
    MultiTaskData,
    ar_covariance,
    gen_classification,
    gen_regression,
    sample_coefficients,
)

__all__ = [
    "coherence", "debias_lasso", "inverse_hessian_m",
    "DsmlResult", "dsml_fit",
    "debias_batched", "inverse_hessian_batched", "power_iteration_batched",
    "scaled_identity_m0", "solve_lasso_batched", "solve_lasso_eq2",
    "solve_logistic_lasso_batched", "sufficient_stats",
    "DsmlLogisticResult", "debias_logistic", "debias_logistic_batched",
    "dsml_logistic_fit", "group_logistic_lasso", "icap_logistic",
    "logistic_lasso", "refit_logistic_masked",
    "classification_error", "estimation_error", "hamming",
    "prediction_error", "support_of",
    "group_hard_threshold", "group_soft_threshold", "project_l1_ball",
    "prox_linf", "soft_threshold", "support_from_rows",
    "fista", "lasso", "lasso_stats_step_scale", "power_iteration",
    "refit_ols_masked", "refit_ols_masked_stats",
    "MultiTaskData", "ar_covariance", "gen_classification",
    "gen_regression",
    "sample_coefficients",
]
