"""The dropless MoE's grouped GEMMs against their roofline in the granite
cell: the least time of the window's expert layers (``yardstick_layered.
expert_bound_s``, from the tokens of each phase's layer calls and the
experts their pairs reached, both counted on the device: the routed
experts' FLOPs at the bf16 peak, or the used experts' weights and the
pairs' rows at the HBM rate, whichever is larger) over the device time of
the library's grouped GEMM in the traced window: CUTLASS's grouped kernel
(its name holds ``GroupProblemShape``) and the launch that prepares its
problem list. Nothing where no such kernel ran."""

KERNELS = ("GroupProblemShape", "prepare_grouped_gemm_data")


def read(cell):
    sv, tr = cell.layer.get("serve"), cell.traced
    if not sv or tr is None or "expert_bound_s" not in sv:
        return None
    t0, t1 = cell.window
    busy = sum(min(e, t1) - max(s, t0) for n, s, e in tr.kernels
               if any(k in n for k in KERNELS) and e > t0 and s < t1)
    if busy <= 0:
        return None
    return 100.0 * sv["expert_bound_s"] / busy
