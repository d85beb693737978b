"""Model operations of one Conv-TasNet forward at the configuration's
widths, ``frames`` encoder frames a window: the encoder, the bottleneck,
each block's two 1x1 convolutions and its depthwise convolution, the
mask head (every stream, the noise's included) and the decoder, two
operations a multiply-add. The norms, PReLUs and the masking are not
counted."""


def forward_flops(widths: dict, batch: int, frames: int) -> float:
    n, length = widths["num_filters"], widths["filter_length"]
    b, h = widths["bottleneck_channels"], widths["conv_channels"]
    streams = widths["num_spk"] + widths["num_noise"]
    block = 2 * b * h * 2 + 2 * h * widths["kernel_size"]
    per_frame = (2 * length * n  # encoder
                 + 2 * n * b  # bottleneck
                 + widths["num_layers"] * widths["num_blocks"] * block
                 + 2 * b * streams * n  # mask head
                 + 2 * streams * n * length)  # decoder
    return float(batch * frames * per_frame)
