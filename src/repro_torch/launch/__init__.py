"""Launch helpers of the port: the pipeline stage partition."""
