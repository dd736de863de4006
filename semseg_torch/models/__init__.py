"""Model zoo (PSPNet on deep-base ResNets), NCHW, reference naming."""
