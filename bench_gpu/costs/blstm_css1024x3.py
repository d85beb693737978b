"""Model operations of one forward of the CSS BLSTM: the embedding, the
input projections and recurrent products of both directions of every
layer, and the mask head."""


def forward_flops(widths: dict, batch: int, frames: int) -> float:
    hd = widths["hidden_dim"]
    h = hd // 2
    bt = batch * frames
    n_out = widths["num_bins"] * (widths["num_spk"] + widths["num_noise"])
    layer = 2 * (2 * bt * hd * 4 * h + 2 * bt * h * 4 * h)
    return (2.0 * bt * widths["idim"] * hd + widths["num_layers"] * layer
            + 2.0 * bt * hd * n_out)
