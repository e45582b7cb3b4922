"""Published peaks of the cards the benchmark knows, by the name that
torch.cuda.get_device_name() gives.  A share of a peak is stated against
these, with the card's power limit beside it (run.py prints it): a card
set below its 700 W runs slower under load."""

PEAKS = {
    # NVIDIA H100 Tensor Core GPU datasheet, SXM5 part: 80 GB HBM3 at
    # 3.35 TB/s
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def for_device(name: str):
    return PEAKS.get(name)
