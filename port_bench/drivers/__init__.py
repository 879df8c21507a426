"""One module a kind of traffic, found by the name a traffic file gives."""
