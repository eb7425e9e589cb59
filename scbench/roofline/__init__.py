"""Frozen work counts and peaks: the yardstick every roofline share is
taken against.  Counts come from the inputs (shapes, lengths,
verdicts the reference works out), never from how the program does it."""
