"""The LM stack's models; so far the dense transformer (``transformer``) and
its layers (``layers``)."""
