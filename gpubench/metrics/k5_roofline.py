"""k5_roofline: the k=5 convs' least time on the card a volume
(``flops_k5.k5_least_seconds``: per launch the larger of its operations at
the bf16 peak and its bytes at the HBM bandwidth) as a share of their
device time a volume, in percent. Their device time is that of the rows
of the tensor-core conv's k=5 instances (:data:`KERNEL`, the kernel name
of ``ctunet_tpu_torch/csrc/conv3d_tc.cu``) launched inside the benchmark's
predict span. None where no such row ran."""

from gpubench import flops_k5, trace_math

# the k=5 instances of the tensor-core conv, as a trace names them
KERNEL = "conv3d_tc_kernel<5,"


def read(view):
    ms = sum(r["ms"] for r in view.rows if KERNEL in r["name"]
             and "gpubench.predict" in r["spans"])
    if not ms or not view.units:
        return None
    least_s = flops_k5.k5_least_seconds(
        flops_k5.layers(view.config["model"], view.canvas),
        trace_math.BF16_FLOP_PER_S, trace_math.HBM_BYTES_PER_S)
    return 100.0 * least_s * 1e3 / (ms / view.units)
