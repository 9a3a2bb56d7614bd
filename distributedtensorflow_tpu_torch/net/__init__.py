"""Resilient network substrate of the port's cross-process transports.

Twin of ``distributedtensorflow_tpu/net/``, framework-free and copied
whole but for the telemetry import (the port's registry, always there):

``net.rpc`` — deadline-bounded, retrying, breaker-guarded unary calls +
persistent-stream dialing + a hard-deadline HTTP GET and POST (the fleet
scrapes and the alert webhook);
``net.breaker`` — the per-endpoint closed/open/half-open circuit
breakers.
"""

from . import breaker, rpc  # noqa: F401
from .breaker import BreakerOpenError, CircuitBreaker, breaker_for  # noqa: F401
from .rpc import (  # noqa: F401
    Deadline,
    DeadlineExceeded,
    RetryPolicy,
    backoff_s,
    call,
    connect_stream,
    connect_with_retry,
    http_get,
    http_post,
    remaining_from_request,
)
