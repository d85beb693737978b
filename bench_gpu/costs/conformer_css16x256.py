"""Model operations of one forward of the CSS Conformer: the products
(Dense layers, attention's three T x T products) and the depthwise
convolution, at the configuration's widths."""


def forward_flops(widths: dict, batch: int, frames: int) -> float:
    d, f = widths["attention_dim"], widths["linear_units"]
    bt = batch * frames
    n_out = widths["num_bins"] * (widths["num_spk"] + widths["num_noise"])
    block = (8 * bt * d * f  # two half-FFNs, two products each
             + 8 * bt * d * d  # q, k, v, out
             + 3 * 2 * batch * frames * frames * d  # q k^T, q pos_k^T, a v
             + 2 * bt * d * widths["kernel_size"])  # depthwise conv
    return (2.0 * bt * widths["idim"] * d + widths["num_blocks"] * block
            + 2.0 * bt * d * n_out)
