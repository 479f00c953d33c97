"""embed.mfu: the encoder's model operations over the traced window (upstream
SAM's, from the configuration: ``work.vit_encode_flops`` per slice) per second,
over the card's bf16 peak, in %."""
from harness.readers import encoder_mfu


def read(run):
    return encoder_mfu(run, run["window"].get("images", 0))
