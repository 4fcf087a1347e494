"""Objective (free-energy) diagnostic checks (counterpart of
``rxinfer_tpu/diagnostics.py``; reference src/score/diagnostics.jl):
``DefaultObjectiveDiagnosticChecks`` guards the free-energy trace against
NaN and Inf, and ``infer(free_energy_diagnostics=...)`` configures it
(``None`` disables every check)."""

from __future__ import annotations

import torch


class ObjectiveDiagnosticCheckNaNs:
    """Error when the objective (Bethe FE) evaluates to NaN."""

    def __repr__(self):
        return "ObjectiveDiagnosticCheckNaNs()"


class ObjectiveDiagnosticCheckInfs:
    """Error when the objective (Bethe FE) evaluates to Inf."""

    def __repr__(self):
        return "ObjectiveDiagnosticCheckInfs()"


DefaultObjectiveDiagnosticChecks = (
    ObjectiveDiagnosticCheckNaNs(),
    ObjectiveDiagnosticCheckInfs(),
)


def apply_fe_diagnostics(checks, fe) -> None:
    """Check a computed free-energy trace (a tensor of any shape) against
    the configured diagnostics on the host."""
    if checks is None:
        return
    if not isinstance(checks, (tuple, list)):
        checks = (checks,)
    fe = torch.as_tensor(fe)
    if fe.numel() == 0:
        return
    for check in checks:
        if isinstance(check, ObjectiveDiagnosticCheckNaNs) \
                and bool(torch.isnan(fe).any()):
            raise FloatingPointError(
                "Failed to compute the final objective value. The result is "
                "`NaN`. Use the `free_energy_diagnostics` keyword argument "
                "in `infer` to suppress this error (reference: "
                "src/score/diagnostics.jl).")
        if isinstance(check, ObjectiveDiagnosticCheckInfs) \
                and bool(torch.isinf(fe).any()):
            raise FloatingPointError(
                "Failed to compute the final objective value. The result is "
                "`Inf`. Use the `free_energy_diagnostics` keyword argument "
                "in `infer` to suppress this error (reference: "
                "src/score/diagnostics.jl).")
