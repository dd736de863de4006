"""What every cell shares: the manifest, traffic, weights, the trace's
reduction, the work counted from shapes and the comparisons."""
