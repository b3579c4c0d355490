"""Continuous-batching decode of the port (``admission``)."""
from .admission import (AdmissionConfig, ContinuousBatcher, KernelDecode,
                        StepRequest, StubDecode, make_decode)

__all__ = ["AdmissionConfig", "ContinuousBatcher", "KernelDecode",
           "StepRequest", "StubDecode", "make_decode"]
