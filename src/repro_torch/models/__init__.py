"""The LM model stack: building blocks (``common``), the block kinds
(``moe``, ``mla``, ``ssd``, ``rglru``) and the model over every family
(``lm``)."""
