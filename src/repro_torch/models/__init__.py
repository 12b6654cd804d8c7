"""The parts of the LM stack that the serving engine runs (``common``,
``lm``); the rest is a later slice of the port."""
