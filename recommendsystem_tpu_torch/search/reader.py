"""Score-log TSV reader (``pso/reader.py``).

13-column TSV of logged predictions + labels; rows containing ``\\N`` or
``-1`` are skipped (``reader.py:20-23``); the card score is the product of
card impression and click predictions (``:38``); random subsampling by
``sample_rate``.
"""

from __future__ import annotations

import random
import time
from typing import List, Tuple


class Reader:
    def __init__(self, filename: str):
        self.filename = filename

    def parse_lines(self, sample_rate: float = 0.005,
                    rng: random.Random | None = None) -> List[List[float]]:
        rng = rng or random.Random()
        s = time.time()
        out: List[List[float]] = []
        with open(self.filename) as f:
            for line in f:
                if rng.random() >= sample_rate:
                    continue
                ok, row = self.parse_line(line)
                if ok:
                    out.append(row)
        print("parsed %d rows from %s (sample_rate=%s, %.3fs)"
              % (len(out), self.filename, sample_rate, time.time() - s))
        return out

    # keep the reference's camelCase entry too
    parseLines = parse_lines

    @staticmethod
    def parse_line(line: str) -> Tuple[bool, List[float]]:
        lt = line.strip("\n").split("\t")
        if "\\N" in lt or "-1" in lt:
            return False, []
        ecom_anchor_clk_pred = float(lt[3])
        ecom_card_imp_pred = float(lt[4])
        ecom_card_clk_pred = float(lt[5])
        ecom_anchor_cvr_pred = float(lt[6])
        staytime_pred = float(lt[7])
        staytime_label = float(lt[8])
        video_anchor_click_label = 1 if int(lt[9]) > 0 else 0
        enhanced_card_click_label = 1 if int(lt[11]) > 0 else 0
        ecom_anchor_cvr_label = 1 if int(lt[12]) > 0 else 0
        return True, [staytime_pred, staytime_label,
                      ecom_anchor_clk_pred, video_anchor_click_label,
                      ecom_card_imp_pred * ecom_card_clk_pred,
                      enhanced_card_click_label,
                      ecom_anchor_cvr_pred, ecom_anchor_cvr_label]
