"""Verification errors: a copy of the JAX package's `errors.py` (the
reference's four-variant `Error` enum), kept here so the port imports
nothing of that package."""

from __future__ import annotations


class Error(Exception):
    """Base class for verification errors."""


class InvalidInstances(Error):
    """Instances don't match the amount specified in the protocol."""


class InvalidProtocol(Error):
    """Protocol that is unreasonable for a verifier."""


class AssertionFailure(Error):
    """Assertion failure during verification."""


class TranscriptError(Error):
    """Transcript (de)serialization failure."""
