"""Model configurations the port can run (`registry.get_arch`)."""
