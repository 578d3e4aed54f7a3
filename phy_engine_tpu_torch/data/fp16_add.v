
module fp16_add(input [15:0] a, input [15:0] b, output [15:0] y);
  wire sa = a[15];
  wire sb = b[15];
  wire [4:0] ea = a[14:10];
  wire [4:0] eb = b[14:10];
  wire [9:0] fa = a[9:0];
  wire [9:0] fb = b[9:0];

  wire a_nan = (ea == 5'd31) & (fa != 10'd0);
  wire b_nan = (eb == 5'd31) & (fb != 10'd0);
  wire a_inf = (ea == 5'd31) & (fa == 10'd0);
  wire b_inf = (eb == 5'd31) & (fb == 10'd0);

  // effective significand (hidden bit) and exponent
  wire [10:0] siga = (ea == 5'd0) ? {1'b0, fa} : {1'b1, fa};
  wire [10:0] sigb = (eb == 5'd0) ? {1'b0, fb} : {1'b1, fb};
  wire [4:0] eea = (ea == 5'd0) ? 5'd1 : ea;
  wire [4:0] eeb = (eb == 5'd0) ? 5'd1 : eb;

  // order operands by magnitude: (exp, sig)
  wire swap = (eeb > eea) | ((eeb == eea) & (sigb > siga));
  wire [10:0] sh = swap ? sigb : siga;     // high
  wire [10:0] sl = swap ? siga : sigb;     // low
  wire [4:0] eh = swap ? eeb : eea;
  wire [4:0] el = swap ? eea : eeb;
  wire s_h = swap ? sb : sa;
  wire s_l = swap ? sa : sb;

  wire [4:0] diff = eh - el;
  // 3 guard bits; 32-bit staging for sticky collection
  wire [31:0] xh = {21'd0, sh} << 3;
  wire [31:0] xl0 = {21'd0, sl} << 3;
  wire [31:0] xl = xl0 >> diff;
  wire sticky_in = ((xl0 & ~(32'hFFFFFFFF << diff)) != 32'd0);
  wire [31:0] xls = xl | {31'd0, sticky_in};

  wire do_sub = s_h ^ s_l;
  wire [15:0] mag = do_sub ? (xh[15:0] - xls[15:0])
                           : (xh[15:0] + xls[15:0]);

  // leading-zero-adjusted normalization over 15 bits (max value
  // 11111111111111x after add: bit 14 possible carry)
  function [4:0] lzc16;
    input [15:0] v;
    integer i;
    begin
      lzc16 = 5'd16;
      for (i = 0; i < 16; i = i + 1)
        if (v[i]) lzc16 = 5'd15 - i[4:0];
    end
  endfunction

  wire [4:0] lz = lzc16(mag);
  // normalized position: hidden bit should land at bit 13
  // (sig<<3 puts hidden at 13; carry-out shifts to 14)
  wire zero_res = (mag == 16'd0);

  // shift left so the MSB sits at bit 14, exponent adjusts with it
  wire [4:0] msb_pos = 5'd15 - lz;                  // valid if !zero_res
  // target: put MSB at 13 (normal) => eadj = msb_pos - 13
  wire signed [6:0] enew0 = {2'b0, eh} + {3'b0, msb_pos[3:0]} - 7'd13
                            - ((msb_pos > 5'd13) ? 7'd0 : 7'd0);
  // (computed via shifts below)

  // renormalize into [13] with guard/sticky
  wire [4:0] shl = (msb_pos < 5'd13) ? (5'd13 - msb_pos) : 5'd0;
  wire [4:0] shr = (msb_pos > 5'd13) ? (msb_pos - 5'd13) : 5'd0;
  wire [15:0] norm0 = mag << shl;
  wire [15:0] norm1 = norm0 >> shr;
  wire shr_sticky = ((norm0 & ~(16'hFFFF << shr)) != 16'd0);
  wire signed [6:0] etmp = {2'b0, eh} + {2'b0, shr} - {2'b0, shl};

  // subnormal handling: if etmp < 1, shift right extra
  wire signed [6:0] und = 7'sd1 - etmp;
  wire [4:0] extra = (und > 0) ? ((und > 7'sd15) ? 5'd15 : und[4:0])
                               : 5'd0;
  wire [15:0] norm2 = norm1 >> extra;
  wire extra_sticky = ((norm1 & ~(16'hFFFF << extra)) != 16'd0);
  wire signed [6:0] efin = (und > 0) ? 7'sd1 : etmp;

  // round to nearest even: frac = norm2[12:3], G = norm2[2],
  // R = norm2[1], S = norm2[0] | shr_sticky | extra_sticky
  wire g = norm2[2];
  wire r = norm2[1];
  wire s = norm2[0] | shr_sticky | extra_sticky;
  wire round_up = g & (r | s | norm2[3]);
  wire [11:0] rounded = {1'b0, norm2[13:3]} + {11'd0, round_up};
  // carry from rounding renormalizes
  wire rnd_carry = rounded[11];
  wire [9:0] frac_out = rnd_carry ? rounded[10:1] : rounded[9:0];
  wire hidden = rnd_carry ? rounded[11] : rounded[10];
  wire signed [6:0] efin2 = efin + (rnd_carry ? 7'sd1 : 7'sd0);

  // exponent encode: hidden==1 -> normal with exp=efin2;
  // hidden==0 -> subnormal (exp=0)
  wire [4:0] eout = hidden ? efin2[4:0] : 5'd0;
  wire overflow = hidden & (efin2 >= 7'sd31);

  wire sign_out = zero_res ? (sa & sb) : s_h;

  wire [15:0] sum_val =
      zero_res ? {sign_out, 15'd0} :
      overflow ? {s_h, 5'd31, 10'd0} :
      {sign_out, eout, frac_out};

  assign y = (a_nan | b_nan) ? 16'h7E00 :
             (a_inf & b_inf) ? ((sa == sb) ? {sa, 5'd31, 10'd0}
                                           : 16'h7E00) :
             a_inf ? a :
             b_inf ? b :
             sum_val;
endmodule
