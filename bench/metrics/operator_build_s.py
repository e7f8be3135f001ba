"""operator_build_s: the host wall of building the operators in set-up
(kernels/ops.ell_operator_pallas: CSR to banked ELLPACK, to the card),
summed over the configuration's matrices."""


def read(run):
    spans = run.span_list("operator_build", "setup")
    return sum(spans) if spans else None
