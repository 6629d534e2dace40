"""Scene makers, one file per scene: ``build(params, device)`` returns the
benchmark's own ``reference.kajiya.Scene``, made from code on the device."""
