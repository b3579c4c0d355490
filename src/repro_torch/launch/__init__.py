"""Entry points of the port: ``serve`` (prefill + decode loop) and
``profile`` (torch.profiler over one served wave)."""
