"""The harness: set-up, window, trace and result line of one run."""
