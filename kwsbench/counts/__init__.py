"""Operations and bytes from shapes, frozen: the work a roofline or an MFU
prices, whatever implements it."""
