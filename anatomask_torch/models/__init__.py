"""Networks (STUNet, built from plans) and their layers."""
