"""Headless animation timeline.

The reference's ``Timeline`` (src/timeline.h:31-168, src/timeline.cpp)
minus the GL button drawing: an integer frame counter over
``[0, max_frame]`` with play/loop state, step semantics, and a sorted
set of marked ("important") keyframe times used for spline editing and
keyframe navigation.
"""

from __future__ import annotations

import bisect
from typing import List


class Timeline:
    """Integer frame timeline with marked keyframe times."""

    def __init__(self, max_frame: int = 1):
        self.current_frame = 0
        self.max_frame = max(1, int(max_frame))
        self.is_playing = False
        self.is_looping = False
        self._times: List[int] = []  # sorted unique marked times

    # -- queries ----------------------------------------------------------
    def get_current_frame(self) -> int:
        return self.current_frame

    def get_max_frame(self) -> int:
        return self.max_frame

    def is_currently_playing(self) -> bool:
        return self.is_playing

    # -- update (timeline.cpp:333-352) -------------------------------------
    def step(self) -> bool:
        """Advance one frame if playing.  Looping wraps through
        ``max_frame`` inclusive; otherwise playback stops at the end."""
        if not self.is_playing:
            return False
        if self.is_looping:
            self.current_frame = (self.current_frame + 1) % (self.max_frame + 1)
            return True
        if self.current_frame >= self.max_frame:
            self.current_frame = self.max_frame
            self.is_playing = False
            return False
        self.current_frame += 1
        return True

    def set_max_frame(self, max_frame: int) -> None:
        """timeline.cpp:355-367: clamps to >= 1 and pulls the cursor in."""
        if max_frame <= 0:
            max_frame = 1
        self.max_frame = max_frame
        if self.current_frame > max_frame:
            self.current_frame = max_frame

    # -- marked times (timeline.cpp:370-418) --------------------------------
    def mark_time(self, time: int) -> bool:
        i = bisect.bisect_left(self._times, time)
        if i < len(self._times) and self._times[i] == time:
            return False
        self._times.insert(i, time)
        return True

    def unmark_time(self, time: int) -> bool:
        i = bisect.bisect_left(self._times, time)
        if i < len(self._times) and self._times[i] == time:
            del self._times[i]
            return True
        return False

    def is_present_time_marked(self) -> bool:
        i = bisect.bisect_left(self._times, self.current_frame)
        return i < len(self._times) and self._times[i] == self.current_frame

    def next_important_time(self) -> int:
        """First marked time strictly after the cursor, else -1."""
        i = bisect.bisect_right(self._times, self.current_frame)
        return self._times[i] if i < len(self._times) else -1

    def previous_important_time(self) -> int:
        """Last marked time strictly before the cursor, else -1."""
        i = bisect.bisect_left(self._times, self.current_frame)
        return self._times[i - 1] if i > 0 else -1

    @property
    def marked_times(self) -> List[int]:
        return list(self._times)

    # -- button actions (timeline.cpp:278-307, 438-455) ---------------------
    def action_rewind(self) -> None:
        self.is_playing = False
        self.current_frame = 0

    def action_goto_end(self) -> None:
        self.is_playing = False
        self.current_frame = self.max_frame

    def action_stop(self) -> None:
        self.is_playing = False

    def action_play(self) -> None:
        self.is_playing = True
        if self.current_frame == self.max_frame:
            self.current_frame = 0

    def action_step_forward(self, n_frames: int = 1) -> None:
        self.is_playing = False
        self.current_frame = (self.current_frame + n_frames) % self.max_frame

    def action_step_backward(self, n_frames: int = 1) -> None:
        self.is_playing = False
        self.current_frame = (
            self.current_frame + self.max_frame - n_frames
        ) % self.max_frame

    def action_loop(self) -> None:
        self.is_looping = not self.is_looping

    def action_toggle_playing(self) -> None:
        self.is_playing = not self.is_playing

    def action_goto_next_key_frame(self) -> None:
        t = self.next_important_time()
        if t >= 0:
            self.current_frame = t

    def action_goto_prev_key_frame(self) -> None:
        t = self.previous_important_time()
        if t >= 0:
            self.current_frame = t

    def make_longer(self, number: int) -> None:
        if number > 0:
            self.max_frame += number

    def make_shorter(self, number: int) -> None:
        if number > 0:
            self.set_max_frame(self.max_frame - number)
