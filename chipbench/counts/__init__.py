"""Operations and bytes from shapes, and the card's frozen peaks. They
import nothing of the program: a later change to the program cannot move
the yardstick."""
