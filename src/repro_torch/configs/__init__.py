"""Model configurations the port serves or trains (``repro/configs``)."""
