"""Result-lake keys. Only the ruleset fingerprint is used so far (the
pipeline's audit record names the ruleset it ran under); the lake store
itself is not ported yet."""
