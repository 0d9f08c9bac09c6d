"""API error taxonomy ↔ HTTP status codes.

Analog of apimachinery `pkg/api/errors/errors.go`: every API failure is a
Status object with reason + code; helpers construct and classify them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class StatusError(Exception):
    """api/errors.StatusError: carries a metav1.Status."""

    def __init__(self, code: int, reason: str, message: str,
                 details: Optional[Dict[str, Any]] = None):
        super().__init__(message)
        self.code = code
        self.reason = reason
        self.message = message
        self.details = details or {}

    def status(self) -> Dict[str, Any]:
        return {
            "apiVersion": "v1",
            "kind": "Status",
            "status": "Failure",
            "message": self.message,
            "reason": self.reason,
            "details": self.details,
            "code": self.code,
        }


def new_not_found(resource: str, name: str) -> StatusError:
    return StatusError(404, "NotFound", f'{resource} "{name}" not found',
                       {"name": name, "kind": resource})


def new_already_exists(resource: str, name: str) -> StatusError:
    return StatusError(409, "AlreadyExists", f'{resource} "{name}" already exists',
                       {"name": name, "kind": resource})


def new_conflict(resource: str, name: str, message: str) -> StatusError:
    return StatusError(409, "Conflict",
                       f'Operation cannot be fulfilled on {resource} "{name}": {message}',
                       {"name": name, "kind": resource})


def new_invalid(kind: str, name: str, message: str) -> StatusError:
    return StatusError(422, "Invalid", f'{kind} "{name}" is invalid: {message}',
                       {"name": name, "kind": kind})


def new_bad_request(message: str) -> StatusError:
    return StatusError(400, "BadRequest", message)


def new_forbidden(resource: str, name: str, message: str) -> StatusError:
    return StatusError(403, "Forbidden", f'{resource} "{name}" is forbidden: {message}')


def new_unauthorized(message: str = "Unauthorized") -> StatusError:
    return StatusError(401, "Unauthorized", message)


def new_method_not_supported(resource: str, action: str) -> StatusError:
    return StatusError(405, "MethodNotAllowed", f"{action} is not supported on {resource}")


def new_timeout(message: str, retry_seconds: int = 0) -> StatusError:
    return StatusError(504, "Timeout", message, {"retryAfterSeconds": retry_seconds})


def new_too_many_requests(message: str, retry_seconds: int = 1) -> StatusError:
    return StatusError(429, "TooManyRequests", message,
                       {"retryAfterSeconds": retry_seconds})


def new_service_unavailable(message: str) -> StatusError:
    """503 — aggregated APIService backend unreachable
    (kube-aggregator proxyHandler error path)."""
    return StatusError(503, "ServiceUnavailable", message)


def new_gone(message: str) -> StatusError:
    """410 Gone — watch/list from a compacted resourceVersion
    (storage.NewTooLargeResourceVersionError / etcd compaction)."""
    return StatusError(410, "Expired", message)


def is_not_found(e: Exception) -> bool:
    return isinstance(e, StatusError) and e.code == 404


def is_already_exists(e: Exception) -> bool:
    return isinstance(e, StatusError) and e.reason == "AlreadyExists"


def is_conflict(e: Exception) -> bool:
    return isinstance(e, StatusError) and e.reason == "Conflict"


def is_invalid(e: Exception) -> bool:
    return isinstance(e, StatusError) and e.code == 422


def is_forbidden(e: Exception) -> bool:
    return isinstance(e, StatusError) and e.code == 403


def is_gone(e: Exception) -> bool:
    return isinstance(e, StatusError) and e.code == 410


def from_status(status: Dict[str, Any]) -> StatusError:
    return StatusError(
        int(status.get("code", 500)),
        status.get("reason", "InternalError"),
        status.get("message", "unknown error"),
        status.get("details") or {},
    )
