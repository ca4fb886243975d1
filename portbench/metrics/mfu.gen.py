"""Generation's share of the card's bf16 peak, in %: the FLOPs of one
request counted on the benchmark's plain reference (the DDIM chain's
U-Net forwards and the KL-VAE decode) times the measured window's
requests, over its seconds and 989 TFLOP/s."""

from portbench import work


def read(record):
    flops = record.work.get("request_flops")
    host = record.host
    if not flops or not host.get("requests"):
        return None
    peak = work.PEAKS["H100"]["bfloat16"] * record.chips
    return 100.0 * flops * host["requests"] / host["window_s"] / peak
