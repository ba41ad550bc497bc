"""Vocabularies.

The VisionLAN dict-file charset, in file order: a-z, then 1..9, then 0
(reference dic_36.txt; id 27 is '1' and id 36 is '0').
"""

import string

DIC_36 = list(string.ascii_lowercase + "1234567890")
