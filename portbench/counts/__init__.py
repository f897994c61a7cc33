"""Operations and bytes, counted from a configuration's shapes alone, and
the card's published peaks: the yardstick of every roofline share and
every share of the peak the benchmark reports."""
