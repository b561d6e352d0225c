"""Operations and bytes of the mixVAE's layers, from a configuration's
shapes alone (frozen here: the program may change, the yardstick may not).

Counting rules:
  * a product of an (m, k) and a (k, n) matrix is 2·m·k·n operations;
  * a training step counts every product's forward, its weight gradient
    and its input gradient once, except fc1's input gradient (x is data);
    no recompute and no 3xTF32 split is counted;
  * bytes are each input read once and each output written once, in the
    configuration's dtype;
  * a kernel's work is a list of calls, each (operations, bytes): its
    bound is the sum of each call's max(operations/peak, bytes/bandwidth).

The configuration is the ``model`` group of ``configs/<name>.json``.
"""

from __future__ import annotations

def layer_shapes(m: dict) -> dict:
    """{layer: (fan_in, fan_out)} of one arm (mmidas/nn_model.py:89-160)."""
    D, F, L, C, S = (m["input_dim"], m["fc_dim"], m["lowD_dim"],
                     m["n_categories"], m["state_dim"])
    shapes = {"fc1": (D, F), "fc2": (F, F), "fc3": (F, F), "fc4": (F, F),
              "fc5": (F, L), "fcc": (L, C), "fc_mu": (L + C, S),
              "fc_sigma": (L + C, S), "fc6": (C + S, L), "fc7": (L, F),
              "fc8": (F, F), "fc9": (F, F), "fc10": (F, F), "fc11": (F, D)}
    if m["mode"] == "ZINB":
        shapes["fc11_p"] = (F, D)
        shapes["fc11_r"] = (F, D)
    return shapes


def forward_flops_per_row(m: dict) -> float:
    """Operations of the forward products of all arms for one row."""
    return 2.0 * m["n_arm"] * sum(i * o for i, o in layer_shapes(m).values())


def train_step_flops(m: dict, batch: int) -> float:
    """Model operations of one training step of ``batch`` rows: forward,
    weight gradients and input gradients (none for fc1)."""
    fwd = forward_flops_per_row(m) * batch
    D, F = m["input_dim"], m["fc_dim"]
    fc1 = 2.0 * m["n_arm"] * D * F * batch
    return 3.0 * fwd - fc1


def eval_flops(m: dict, rows: int) -> float:
    """Model operations of the eval forward (loss included) of ``rows``."""
    return forward_flops_per_row(m) * rows


def _out_layer(m: dict, rows: int, heads: int, products: int,
               grads: bool, nbytes: int) -> list:
    """[(operations, bytes)] of one call: ``heads`` (F → D) output layers
    on ``rows`` rows and their loss against x (rows, D), which the arms
    share; ``products`` products of the layer's size; with ``grads`` dh,
    dW and db are written."""
    A, D, F = m["n_arm"], m["input_dim"], m["fc_dim"]
    flops = products * 2.0 * A * rows * F * D
    read = A * rows * F + heads * A * (F * D + D) + rows * D
    write = A * 2   # the loss sums (and the mismatch counts)
    if grads:
        write += A * rows * F + heads * A * (F * D + D)
    return [(flops, (read + write) * nbytes)]


def encoder_fc1(m: dict, rows: int, nbytes: int) -> list:
    """fc1's forward (dropout drawn in-kernel) and its weight gradient on
    ``rows`` rows of shared x: two calls, each (operations, bytes)."""
    A, D, F = m["n_arm"], m["input_dim"], m["fc_dim"]
    one = 2.0 * A * rows * D * F
    fwd = (rows * D + A * (D * F + F) + A * rows * F) * nbytes
    bwd = (rows * D + A * rows * F + A * (D * F + F)) * nbytes
    return [(one, fwd), (one, bwd)]


def recon_train(m: dict, rows: int, nbytes: int) -> list:
    """The MSE output layer and loss, forward and backward: three products."""
    return _out_layer(m, rows, 1, 3, True, nbytes)


def recon_serve(m: dict, rows: int, nbytes: int) -> list:
    """The MSE output layer and loss, forward only: one product."""
    return _out_layer(m, rows, 1, 1, False, nbytes)


def zinb_train(m: dict, rows: int, nbytes: int) -> list:
    """The three ZINB heads and their loss, forward and backward: nine."""
    return _out_layer(m, rows, 3, 9, True, nbytes)


def zinb_serve(m: dict, rows: int, nbytes: int) -> list:
    """The three ZINB heads and their loss, forward only: three."""
    return _out_layer(m, rows, 3, 3, False, nbytes)
