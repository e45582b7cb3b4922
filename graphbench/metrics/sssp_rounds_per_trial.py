"""Relax rounds a trial: the mean `iterations` of the port's SSSP solves
over the sampled trials (kernels/sssp.py's check).  Reads the solvers'
host loop (solvers/sssp._bucket_rounds): each round ends in one host
read, and one more read finds the frontier empty.  Moves trials_per_s."""


def read(run):
    return run.get("reference", {}).get("rounds_mean")
