"""Operations and bytes the window's work needs, one file a kernel family,
and the table of peaks. A roofline share is the least time the chip could
take (``peaks.bound_s``) over the family's device time; the operations and
bytes are counted from the traffic's work, each input byte read once and each
output byte written once."""
