"""The verifier's errors (the reference's `Error` enum)."""

from __future__ import annotations


class Error(Exception):
    """Base class for verification errors."""


class InvalidInstances(Error):
    """Instances don't match the amount specified in the protocol."""


class InvalidProtocol(Error):
    """Protocol that is unreasonable for a verifier."""


class TranscriptError(Error):
    """Transcript (de)serialization failure."""
