"""The protocol: weak learners, BoostAttempt, AccuratelyClassify and
the batched stepping engine (integer and feature tracks)."""
