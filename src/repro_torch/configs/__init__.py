"""Architecture configs of the LM stack (``registry.get_arch``)."""
