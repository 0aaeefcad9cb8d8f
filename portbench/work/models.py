"""Forward FLOPs of the paper's models (Sec. IV-A2), counted from the
configuration's shapes: two FLOPs a multiply-add of every convolution and
dense layer; bias adds, ReLU and pooling are not counted. A local SGD
step is counted as three forward passes (forward, and the backward's two
products), an evaluation as one."""
from __future__ import annotations


def _conv_flops(h, w, cin, cout, k):
    return 2 * h * w * cout * k * k * cin


def forward_flops(cfg) -> int:
    """FLOPs of one example's forward pass of the configuration ``cfg``
    (a ``configs/<name>.json`` dict)."""
    kind = cfg["model"]
    if kind == "mlp":
        dims = [cfg["d_input"], *cfg["hidden"], cfg["classes"]]
        return sum(2 * a * b for a, b in zip(dims, dims[1:]))
    if kind == "cnn":
        h, w, c = cfg["input_shape"]
        k, pool = cfg["kernel_size"], cfg["pool"]
        total = 0
        for cout in cfg["conv_channels"]:
            total += _conv_flops(h, w, c, cout, k)   # "same" padding
            h, w, c = h // pool, w // pool, cout
        return total + 2 * h * w * c * cfg["classes"]
    raise ValueError(f"unknown model kind {kind!r}")


def round_flops(cfg, cell) -> dict:
    """FLOPs of one FL round of ``cell``: every user's local steps (three
    forward passes an example) and one evaluation of the test set."""
    fwd = forward_flops(cfg)
    steps = cell["local_epochs"] * (cell["examples_per_user"]
                                    // cell["batch_size"])
    trained = cell["users"] * steps * cell["batch_size"]
    return {"train": 3 * fwd * trained, "eval": fwd * cell["test_examples"],
            "local_steps": steps}
